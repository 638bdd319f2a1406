"""PyTorch/CUDA port of the cascaded-inference system.

A second implementation beside the JAX package ``repro`` (the reference),
laid out the same way: ``configs``, ``models``, ``core``, ``serving`` and
``kernels``, the last holding hand-written Hopper (sm_90a) kernels with a
plain PyTorch version of each.  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
