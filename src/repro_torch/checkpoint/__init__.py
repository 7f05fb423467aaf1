from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               CheckpointCorruptError,
                                               latest_step, manifest_keys,
                                               restore_checkpoint,
                                               save_checkpoint)

__all__ = ["AsyncCheckpointer", "CheckpointCorruptError", "latest_step",
           "manifest_keys", "restore_checkpoint", "save_checkpoint"]
