from repro_torch.ckpt.checkpoint import (latest_step, load_checkpoint,
                                         save_checkpoint, tree_digest)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "tree_digest"]
