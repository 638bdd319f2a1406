from repro_torch.data.lm_pipeline import SyntheticLMStream, shard_batch
from repro_torch.data.synth_images import SynthImageDataset, make_image_splits

__all__ = ["SynthImageDataset", "make_image_splits", "SyntheticLMStream",
           "shard_batch"]
