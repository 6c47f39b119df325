"""Train-step factory: loss + gradients + AdamW on one device, microbatch
gradient accumulation, and an optional HHE-encrypted data plane (batches
arrive as Rubato/HERA ciphertext and are decrypted on the device by
keystream subtraction, the paper's cipher fused into the input pipeline).

The port's copy of `repro.train.train_loop` without its sharding: the
reference's ``policy`` argument, ``batch_specs``/``act_shardings`` and the
specs dict it returns belong to the multi-card slice.  The step updates
the parameters and the optimizer state in place (the reference donates
them).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.optimizer import OptConfig, adamw_update
from repro_torch.train.tree import leaves, unflatten


def _on_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _interleaved(x, m: int):
    """(B, ...) -> (m, B/m, ...) with microbatch i = rows i, i+m, ...: the
    reference's (B,) -> (B/m, m) -> (m, B/m) split."""
    b = x.shape[0]
    return x.reshape((b // m, m) + tuple(x.shape[1:])).movedim(1, 0)


class _Marks:
    """Phase boundaries of one step: CUDA events on the card (read once
    the step is done), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
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
    step trained on."""

    def __init__(self, cfg: ModelConfig, opt: OptConfig, microbatch: int,
                 decryptor, device: torch.device):
        self.cfg = cfg
        self.opt = opt
        self.microbatch = microbatch
        self.decryptor = decryptor
        self.device = device
        self.last_batch: Optional[dict] = None

    def _loss_and_grads(self, params, flat, batch):
        loss, _ = M.loss_fn(self.cfg, params, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # a leaf the loss never reads (an encoder's text embedding) has a
        # zero gradient, as jax.grad gives it
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for g, p in zip(grads, flat)]

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
            gsum = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                    for p in flat]
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
                    decryptor=None, device=None) -> TrainStep:
    """The train step on ``device`` (default: the card; raises without one
    unless ``device="cpu"``).  If ``decryptor`` is given (see
    ``data/encrypted.py``), the batch carries ciphertext and block
    counters and is decrypted on the device first."""
    return TrainStep(cfg, opt, microbatch, decryptor, resolve_device(device))
