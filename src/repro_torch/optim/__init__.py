from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                    global_norm_clip, resolve_moment_policy)
from repro_torch.optim.loops import scan_epoch
from repro_torch.optim.schedule import (constant_schedule, cosine_schedule,
                                        linear_schedule)

__all__ = ["adamw_init", "adamw_update", "global_norm_clip",
           "resolve_moment_policy", "cosine_schedule", "linear_schedule",
           "constant_schedule", "scan_epoch"]
