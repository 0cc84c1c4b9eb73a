from repro_torch.checkpoint.ckpt import (ChecksumError, checkpoint_sharding,
                                         consolidate, load_checkpoint,
                                         load_replica_state, save_checkpoint,
                                         save_replica_state)

__all__ = ["ChecksumError", "checkpoint_sharding", "consolidate",
           "load_checkpoint", "load_replica_state", "save_checkpoint",
           "save_replica_state"]
