"""The replicated WAGMA-SGD train step.  Counterpart of ``repro/train``."""

from repro_torch.train.train_step import (build_train_step, guarded_update,
                                          init_replica_state, stacked_init,
                                          tree_all_finite)

__all__ = ["build_train_step", "guarded_update", "init_replica_state",
           "stacked_init", "tree_all_finite"]
