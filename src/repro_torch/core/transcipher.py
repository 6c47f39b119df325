"""RtF transciphering scaffold — the *server* side of HHE (paper §II).

The port's copy of `repro.core.transcipher`.  The keystream circuit is
evaluated as an arithmetic circuit over Z_q with multiplicative-depth
tracking (:class:`DepthTracked`), interpreting the same
``build_schedule(params)`` program the client engines run, on int64
tensors on the cipher's device.  Rubato's Feistel is depth 1 a round,
HERA's Cube depth 2, PASTA's (r−1) Feistels and one Cube r+1 (4 for
pasta-128l).  Transciphering then recovers the encoded message slots
that CKKS HalfBoot would carry: (c − z) decoded.

The circuit is plain PyTorch (the reference's is plain jnp; it has no
Pallas kernel).  Its round constants come from the cipher's producer,
so on a card the ``aes`` producer's AES kernel draws them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import rounds as R
from repro_torch.core import schedule as S
from repro_torch.core.cipher import Cipher, as_int64, make_cipher, sub_words
from repro_torch.core.params import CipherParams


@dataclasses.dataclass
class DepthTracked:
    """A Z_q value paired with its multiplicative depth.

    Mirrors FV noise-budget accounting: plaintext·ciphertext products (the
    k ⊙ rc key schedule) and additions are depth-free; ciphertext ×
    ciphertext multiplies take max(depth_a, depth_b) + 1.
    """

    value: Any
    depth: int = 0


class CircuitMod:
    """Adapter exposing the Modulus interface over DepthTracked values."""

    def __init__(self, params: CipherParams):
        self.params = params
        self.mod = params.mod

    def add(self, a: DepthTracked, b: DepthTracked) -> DepthTracked:
        return DepthTracked(self.mod.add(a.value, b.value),
                            max(a.depth, b.depth))

    def mul_ct(self, a: DepthTracked, b: DepthTracked) -> DepthTracked:
        return DepthTracked(self.mod.mul(a.value, b.value),
                            max(a.depth, b.depth) + 1)

    def mul_pt(self, a: DepthTracked, pt) -> DepthTracked:
        """Plaintext multiply — depth-free in the FV accounting."""
        return DepthTracked(self.mod.mul(a.value, pt), a.depth)


def evaluate_decryption_circuit(cipher: Cipher, block_ctrs):
    """Evaluate the stream-key circuit with depth tracking.

    Interprets the normal-orientation ``build_schedule(params)`` program
    (orientation is a client-side layout concern; the FV circuit is slot
    order agnostic) on (lanes, n) int64 values on the cipher's device.
    Returns (keystream (lanes, l) int64, mult_depth).  The AGN stage is
    the client's: the server's circuit stops before it.
    """
    p = cipher.params
    sched = S.build_schedule(p)
    if torch.is_tensor(block_ctrs):
        block_ctrs = block_ctrs.cpu()
    ctrs = np.asarray(block_ctrs, np.int64).reshape(-1)
    consts = cipher.round_constant_stream(ctrs)
    cm = CircuitMod(p)
    mod = p.mod
    lanes = ctrs.shape[0]

    key = cipher.key.expand(lanes, p.n)
    # the key is the FV-encrypted input; everything derived carries depth
    k = DepthTracked(key, 0)
    if sched.init == "key":
        x = DepthTracked(key, 0)                 # PASTA: keyed permutation
    else:
        ic = torch.as_tensor(R.ic_vector(p).astype(np.int64),
                             device=cipher.device)
        x = DepthTracked(ic.expand(lanes, p.n), 0)

    def cube(x):
        sq = cm.mul_ct(x, x)
        return cm.mul_ct(sq, x)

    def feistel(x):
        b = p.branches
        val = x.value.reshape(x.value.shape[:-1]
                              + (b, x.value.shape[-1] // b))
        head = DepthTracked(val[..., :-1], x.depth)
        sq = cm.mul_ct(head, head)
        shifted = torch.cat([torch.zeros_like(val[..., :1]), sq.value],
                            dim=-1)
        out = mod.add(val, shifted).reshape(x.value.shape)
        return DepthTracked(out, max(x.depth, sq.depth))

    rc = consts["rc"]
    for op in sched.ops:
        if isinstance(op, S.ARK):
            a, b = op.rc_slice
            kt = DepthTracked(k.value[..., : op.key_len], k.depth)
            x = cm.add(x, cm.mul_pt(kt, rc[..., a:b]))
        elif isinstance(op, S.MRMC):
            if op.streams_matrix:
                # the streamed dense affine layer's matrix is public
                # per-block randomness: plaintext multiplies and adds,
                # depth-free like the static circulant path
                ma, mb = op.mat_slice
                m = consts["mats"][..., ma:mb]
                t = p.n // p.branches
                M = m.reshape(m.shape[:-1] + (p.branches, t, t))
                X = x.value.reshape(x.value.shape[:-1] + (p.branches, t))
                val = mod.matvec_dense(M, X).reshape(x.value.shape)
            else:
                val = R.mrmc(p, x.value)         # plaintext linear
            if op.has_rc:
                a, b = op.rc_slice
                val = mod.add(val, rc[..., a:b])  # plaintext add
            if op.mix_branches:
                val = R.branch_mix(p, val)       # ct+ct adds: depth-free
            x = DepthTracked(val, x.depth)
        elif isinstance(op, S.NONLINEAR):
            x = cube(x) if op.kind == "cube" else feistel(x)
        elif isinstance(op, S.TRUNCATE):
            x = DepthTracked(x.value[..., : op.keep], x.depth)
        elif isinstance(op, S.AGN):
            # the client adds the noise; it rides inside the symmetric
            # ciphertext (Rubato's own noise doubles as HE noise)
            pass
    return x.value, x.depth


def measured_depth(params: CipherParams, seed: int = 0, device=None) -> int:
    """Multiplicative depth the depth-tracked circuit accumulates on one
    block — the executable half of the depth cross-check
    (`repro_torch.analysis.bounds.depth_report`)."""
    ci = make_cipher(params.name, seed=seed, device=device)
    _, depth = evaluate_decryption_circuit(ci, np.arange(1))
    return int(depth)


def transcipher(cipher: Cipher, c, block_ctrs, delta: float = 1024.0):
    """Server-side transciphering: symmetric ciphertext -> "CKKS slots".

    Evaluates the decryption circuit, subtracts the stream key and decodes
    the fixed-point slots.  ``c`` is (lanes, l) for every cipher (HERA has
    l == n; Rubato and PASTA truncate to l).  Returns (slots float32,
    mult_depth).
    """
    z, depth = evaluate_decryption_circuit(cipher, block_ctrs)
    l = cipher.params.l
    if z.shape[-1] != l:
        raise AssertionError(
            f"decryption circuit produced {z.shape[-1]} slots, expected l={l}")
    c = as_int64(c, z.device)
    if c.shape[-1] != l:
        raise ValueError(f"ciphertext last dim {c.shape[-1]} != l={l}")
    mq = sub_words(cipher.params.mod, c, z)
    return cipher.decode(mq, delta), depth
