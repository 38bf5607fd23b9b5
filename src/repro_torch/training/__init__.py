from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, cosine_schedule,
                                            global_norm)
from repro_torch.training.train_loop import (init_opt_state,
                                             make_train_step, train)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "init_opt_state", "make_train_step", "train",
           "save_checkpoint", "load_checkpoint"]
