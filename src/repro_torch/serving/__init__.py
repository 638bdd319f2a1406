"""Serving: depth-compacted lane batching, the cascade serving engine and
the device decode loop; the names the JAX package's ``repro.serving``
exports."""
from repro_torch.serving.engine import CascadeServingEngine, Request
from repro_torch.serving.batching import DepthCompactor
from repro_torch.serving.runtime import DecodeChunk, DeviceDecodeLoop

__all__ = ["CascadeServingEngine", "Request", "DepthCompactor",
           "DecodeChunk", "DeviceDecodeLoop"]
