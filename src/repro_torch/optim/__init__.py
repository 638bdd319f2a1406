from repro_torch.optim.optimizer import (Optimizer, adamw, apply_updates,
                                         clip_by_global_norm, sgd_momentum)
from repro_torch.optim.schedule import (constant_schedule, cosine_schedule,
                                        resnet_paper_schedule, warmup_cosine)

__all__ = ["Optimizer", "adamw", "sgd_momentum", "clip_by_global_norm",
           "apply_updates", "constant_schedule", "cosine_schedule",
           "resnet_paper_schedule", "warmup_cosine"]
