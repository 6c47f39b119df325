"""The port's hand-written CUDA kernels (``csrc/``) for the compute hot
spots the paper accelerates, with the names `repro.kernels` exports.

Each kernel directory has ``ops.py`` (the wrapper: operand checks,
launch, launch count; CPU tensors take the plain version) and ``ref.py``
(the plain PyTorch version the kernel is held against; the sampler
kernels' plain versions are `crypto/sampler.py`'s).  Importing builds
no kernel and touches no device: `kernels/build.py` compiles the sources
at the first launch.
"""

from repro_torch.kernels.mrmc.ops import mrmc_kernel_apply
from repro_torch.kernels.keystream.ops import keystream_kernel_apply
from repro_torch.kernels.aes.ops import aes_ctr_kernel_apply

__all__ = [
    "mrmc_kernel_apply",
    "keystream_kernel_apply",
    "aes_ctr_kernel_apply",
]
