"""Slab layout, fused-update kernels (CUDA, sm_90a) and their plain
PyTorch versions. Importing builds nothing: the CUDA library is compiled at
its first launch."""
