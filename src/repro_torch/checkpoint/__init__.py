from repro_torch.checkpoint.store import (checkpoint_exists, checkpoint_meta,
                                          checkpoint_step, restore_pytree,
                                          save_pytree)

__all__ = ["checkpoint_exists", "checkpoint_meta", "checkpoint_step",
           "restore_pytree", "save_pytree"]
