"""Prefill / decode step factories.

The port's copy of `repro.serve.serve_loop`: closures over
:mod:`repro_torch.models.model` on one device (default: the card).  A
step moves its token batch to that device, checks that the parameters
live there, and runs without autograd.  The decode step writes the new
token's keys, values and SSM state into the cache it is given, in place
(the reference donates the cache).

With a ``policy`` (:mod:`repro_torch.models.sharding`) the steps are the
reference's sharded ones over ``torch.distributed``: every rank of the
policy's mesh calls them, the parameters are DTensors laid out by
``param_specs``, the cache follows ``cache_specs`` (written in place on
each rank's shard), and the tokens are scattered from rank 0 by the
batch's spec (``distribute_tensor``), so only rank 0 needs the real
ones; logits come back as DTensors.  For a batch of 1 on dp > 1 the
policy shards the sequence instead of the batch (the reference's
long-context decode).
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


def _acts(cfg: ModelConfig, policy, decode: bool):
    if policy is None:
        return None
    from repro_torch.train.train_loop import act_shardings

    acts = act_shardings(cfg, policy)
    if decode and policy.seq_shard_data:
        # batch-1 decode: one token, logits sharded over the vocab only
        acts = {"acts": None, "logits": (None, None, policy.tp_full),
                "_policy": policy}
    return acts


def _place_tokens(cfg, policy, batch: dict, decode: bool) -> dict:
    """Rank 0's token batch scattered by the batch's spec."""
    if policy is None:
        return batch
    from repro_torch.train.train_loop import batch_specs

    if decode:
        spec = (policy.dp, None) if not policy.seq_shard_data else (None, None)
        return {k: M.place(v, policy, spec) for k, v in batch.items()}
    specs = batch_specs(cfg, policy, train=False)
    return {k: M.place(v, policy, specs[k]) for k, v in batch.items()}


def _grad_free(policy):
    # DTensor views of parameters made outside inference mode cannot be
    # taken inside it; no_grad serves the sharded steps
    return torch.inference_mode() if policy is None else torch.no_grad()


def make_prefill_step(cfg: ModelConfig, max_len: int, device=None,
                      policy=None):
    """``step(params, batch) -> (last_logits (B,1,Vp), cache, cur_len)``."""
    dev = resolve_device(device)
    acts = _acts(cfg, policy, decode=False)

    def step(params, batch):
        _check_params(params, dev)
        with _grad_free(policy):
            batch = _place_tokens(cfg, policy, _to(batch, dev), False)
            return M.prefill(cfg, params, batch, max_len, shardings=acts)

    return step


def make_decode_step(cfg: ModelConfig, device=None, policy=None):
    """``step(params, cache, tokens (B,1), cur_len) -> (logits, cache)``."""
    dev = resolve_device(device)
    acts = _acts(cfg, policy, decode=True)

    def step(params, cache, tokens, cur_len: int):
        _check_params(params, dev)
        with _grad_free(policy):
            tok = _place_tokens(cfg, policy,
                                {"tokens": torch.as_tensor(tokens).to(dev)},
                                True)["tokens"]
            return M.decode_step(cfg, params, cache, tok, cur_len,
                                 shardings=acts)

    return step
