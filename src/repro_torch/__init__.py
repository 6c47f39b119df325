"""PyTorch/CUDA port of the Presto HHE keystream system.

A second package beside the JAX reference `repro`: the same module names
and layout, plain PyTorch functions on tensors, and hand-written CUDA
kernels (``csrc/``) for the fused keystream, MRMC and AES-CTR datapaths.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
