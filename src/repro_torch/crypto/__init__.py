"""The port's cryptographic substrate: Z_q arithmetic on int64 tensors,
AES-128, the XOF and the samplers, with the names `repro.crypto`
exports.  Importing it builds no kernel and touches no device.
"""

from repro_torch.crypto.modmath import Modulus, Q_HERA, Q_RUBATO
from repro_torch.crypto.aes import (
    aes128_encrypt_blocks,
    aes128_key_expand,
    aes_ctr_keystream,
)
from repro_torch.crypto.xof import make_xof, xof_words
from repro_torch.crypto.sampler import (
    DGaussTable,
    discrete_gaussian,
    uniform_mod_q,
)

__all__ = [
    "Modulus",
    "Q_HERA",
    "Q_RUBATO",
    "aes128_encrypt_blocks",
    "aes128_key_expand",
    "aes_ctr_keystream",
    "make_xof",
    "xof_words",
    "uniform_mod_q",
    "discrete_gaussian",
    "DGaussTable",
]
