"""Prefill / decode step factories.

The port's copy of `repro.serve.serve_loop` without a sharding policy:
plain closures over :mod:`repro_torch.models.model` on one device
(default: the card).  A step moves its token batch to that device, checks
that the parameters live there, and runs under ``torch.inference_mode``.
The decode step writes the new token's keys, values and SSM state into
the cache it is given, in place (the reference donates the cache).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def _check_params(params, dev: torch.device) -> None:
    got = params["embed"].device
    if got != dev:
        raise ValueError(f"parameters on {got}, the step runs on {dev}")


def _to(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def make_prefill_step(cfg: ModelConfig, max_len: int, device=None):
    """``step(params, batch) -> (last_logits (B,1,Vp), cache, cur_len)``."""
    dev = resolve_device(device)

    def step(params, batch):
        _check_params(params, dev)
        with torch.inference_mode():
            return M.prefill(cfg, params, _to(batch, dev), max_len)

    return step


def make_decode_step(cfg: ModelConfig, device=None):
    """``step(params, cache, tokens (B,1), cur_len) -> (logits, cache)``."""
    dev = resolve_device(device)

    def step(params, cache, tokens, cur_len: int):
        _check_params(params, dev)
        with torch.inference_mode():
            return M.decode_step(cfg, params, cache,
                                 torch.as_tensor(tokens).to(dev), cur_len)

    return step
