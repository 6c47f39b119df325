"""Train-step factory: loss + gradients + AdamW on one device, microbatch
gradient accumulation, and an optional HHE-encrypted data plane (batches
arrive as Rubato/HERA ciphertext and are decrypted on the device by
keystream subtraction, the paper's cipher fused into the input pipeline).

The port's copy of `repro.train.train_loop`.  The step updates the
parameters and the optimizer state in place (the reference donates them).

With a ``policy`` (:mod:`repro_torch.models.sharding`) the step is the
reference's sharded one over ``torch.distributed``: every rank of the
policy's mesh calls it with the same batch, the parameters and moments
are DTensors laid out by ``param_specs``/``opt_state_specs``, each rank
decrypts the whole batch and keeps its slice of it (``batch_specs``; no
data moves, and the block counters are the batch's own), and the loss
and gradients run on DTensors under ``act_shardings``.  ``policy=None``
is the one-device step.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.sharding import P
from repro_torch.train.optimizer import (
    OptConfig,
    adamw_update,
    opt_state_specs,
)
from repro_torch.train.tree import leaves, unflatten


def batch_specs(cfg: ModelConfig, policy, *, train: bool = True) -> dict:
    """The batch's specs (the reference's): tokens/labels over dp (or the
    sequence over dp for a batch of 1), frontend embeddings and M-RoPE
    positions likewise with a trailing whole dim."""
    bs = tuple(policy.batch_spec())
    d: dict = {}
    if cfg.frontend == "none":
        d["tokens"] = bs
    else:
        d["embeds"] = P(*bs, None)
        if cfg.rope_kind == "mrope":
            d["positions"] = P(*bs, None)
    if train:
        d["labels"] = bs
    return d


def act_shardings(cfg: ModelConfig, policy) -> dict:
    """The activation specs a sharded pass redistributes to (the
    reference's, as specs): layer-boundary activations over dp and the
    model axes, logits over the vocab, attention heads on the tp sub-axes,
    Mamba inner channels over the model axes; ``_policy`` carries the
    policy into the layers (the MoE and attention bodies read its mesh).
    The port's attention takes its 4-d (B, T, H, hd) form of "q" with the
    sequence whole (:func:`repro_torch.models.model._attn_sharded`)."""
    bs = tuple(policy.batch_spec())
    b = bs[0] if not policy.seq_shard_data else None
    t = bs[1]
    return {
        "acts": P(bs[0], bs[1], policy.tp_full),
        "logits": P(bs[0], bs[1], policy.tp_full),
        "q": P(b, t, "tp_a", "tp_b", None),
        "kv": P(b, t, "tp_a", None),
        "ssm_inner": P(b, t, policy.tp_full),
        "_policy": policy,
    }


def _on_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _interleaved(x, m: int):
    """(B, ...) -> (m, B/m, ...) with microbatch i = rows i, i+m, ...: the
    reference's (B,) -> (B/m, m) -> (m, B/m) split."""
    b = x.shape[0]
    return x.reshape((b // m, m) + tuple(x.shape[1:])).movedim(1, 0)


class _Marks:
    """Phase boundaries of one step: CUDA events on the card (read once
    the step is done), the host clock on the CPU and in a pass over fake
    tensors (``launch.dryrun``), which runs nothing on the card."""

    def __init__(self, dev: torch.device):
        from torch._guards import detect_fake_mode

        self.cuda = dev.type == "cuda" and detect_fake_mode() is None
        self.marks = []
        self.mark()

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> list:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                       self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


class TrainStep:
    """``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    metrics)`` with metrics ``loss`` (with the aux term), ``grad_norm`` and
    ``lr``.  ``params`` is a trainable :class:`repro_torch.models.model.
    Model`; ``batch`` holds numpy arrays or tensors (``{"tokens",
    "labels"}``, or ``{"ct", "base_ctr"}`` for the decryptor).  Passing a
    dict as ``times`` fills it with the step's ``decrypt_ms``,
    ``fwd_bwd_ms``, ``adamw_ms`` and ``step_ms`` (CUDA events on the card)
    and waits for the step; ``last_batch`` is the plaintext batch the last
    step trained on.  With a policy, ``specs`` holds the reference's
    ``{"params", "opt", "batch"}`` specs (else None)."""

    def __init__(self, cfg: ModelConfig, opt: OptConfig, microbatch: int,
                 decryptor, device: torch.device, policy=None):
        self.cfg = cfg
        self.opt = opt
        self.microbatch = microbatch
        self.decryptor = decryptor
        self.device = device
        self.policy = policy
        self.last_batch: Optional[dict] = None
        self.acts = self.specs = None
        if policy is not None:
            self.acts = act_shardings(cfg, policy)
            pspecs = M.param_specs(cfg, policy)
            bspecs = ({"ct": policy.batch_spec(), "base_ctr": ()}
                      if decryptor is not None
                      else batch_specs(cfg, policy, train=True))
            self.specs = {"params": pspecs,
                          "opt": opt_state_specs(pspecs, M.param_defs(cfg),
                                                 opt),
                          "batch": bspecs}
            self._plain_specs = batch_specs(cfg, policy, train=True)

    def _place(self, batch: dict) -> dict:
        """Each rank's slice of the (same) batch every rank holds."""
        if self.policy is None:
            return batch
        return {k: M.place(v, self.policy, self._plain_specs[k],
                           src_data_rank=None) for k, v in batch.items()}

    def _loss_and_grads(self, params, flat, batch):
        loss, _ = M.loss_fn(self.cfg, params, self._place(batch),
                            shardings=self.acts)
        with M.sharded_context(self.acts):
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # a leaf the loss never reads (an encoder's text embedding) has a
        # zero gradient, as jax.grad gives it; a DTensor gradient is laid
        # out as its parameter
        out = []
        for g, p in zip(grads, flat):
            if g is None:
                g = torch.zeros_like(p)
            elif (self.policy is not None
                  and tuple(g.placements) != tuple(p.placements)):
                g = g.redistribute(p.device_mesh, p.placements)
            out.append(g)
        loss = loss.detach()
        if self.policy is not None:
            loss = loss.full_tensor()
        return loss, out

    def __call__(self, params, opt_state, batch, step_idx,
                 times: Optional[dict] = None):
        marks = _Marks(self.device)
        batch = _on_device(batch, self.device)
        if self.decryptor is not None:
            batch = self.decryptor(batch)
        self.last_batch = batch
        marks.mark()

        flat = leaves(params)
        if not all(p.requires_grad for p in flat):
            raise ValueError("the parameters carry no gradient: call "
                             "requires_grad_() on the model")
        m = self.microbatch
        if m > 1:
            parts = {k: _interleaved(v, m) for k, v in batch.items()}
            # accumulate in bf16 for bf16 masters, else in float32
            acc_dt = (torch.bfloat16 if self.cfg.param_dtype == "bfloat16"
                      else torch.float32)
            gsum = [torch.zeros_like(p, dtype=acc_dt) for p in flat]
            lsum = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(m):
                loss, grads = self._loss_and_grads(
                    params, flat, {k: v[i] for k, v in parts.items()})
                for a, g in zip(gsum, grads):
                    a.add_(g.to(a.dtype))
                lsum = lsum + loss
                del grads
            grads = [g / m for g in gsum]
            loss = lsum / m
        else:
            loss, grads = self._loss_and_grads(params, flat, batch)
        marks.mark()

        params, opt_state, om = adamw_update(
            params, unflatten(params, grads), opt_state, int(step_idx),
            self.opt)
        marks.mark()
        if times is not None:
            dec, fb, upd = marks.ms()
            times.update(decrypt_ms=dec, fwd_bwd_ms=fb, adamw_ms=upd,
                         step_ms=dec + fb + upd)
        return params, opt_state, {"loss": loss, **om}


def make_train_step(cfg: ModelConfig, opt: OptConfig, *, microbatch: int = 1,
                    decryptor=None, device=None, policy=None) -> TrainStep:
    """The train step on ``device`` (default: the card; raises without one
    unless ``device="cpu"``).  If ``decryptor`` is given (see
    ``data/encrypted.py``), the batch carries ciphertext and block
    counters and is decrypted on the device first.  ``policy`` makes it
    the sharded step over the policy's mesh (see the module's note)."""
    return TrainStep(cfg, opt, microbatch, decryptor, resolve_device(device),
                     policy)
