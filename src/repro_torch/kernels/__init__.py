"""Slab layout and the hand-written CUDA kernels (sm_90a) with their plain
PyTorch versions: the fused update, the tier cast, flash attention forward
and ragged decode. Importing builds nothing: each CUDA library is compiled
at its first launch."""
