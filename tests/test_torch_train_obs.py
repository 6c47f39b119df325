"""The train path's spans and the experts' counters (`repro_torch.obs`):
``train.fwd_bwd``, ``train.adamw``, ``data.decrypt``, ``ssm.scan``,
``moe.route``, ``moe.experts``, ``moe.shared``, and the ``moe.routed`` /
``moe.computed`` counters, on granite-4.0-h-small's smoke configuration
with an expert share: off without a profiler, one set a step under one,
nested in the step's spans, and counted once a forward pass when a
checkpointed layer is recomputed.  Imports only the port."""

import dataclasses
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cipher import make_cipher  # noqa: E402
from repro_torch.data.encrypted import encrypt_tokens, make_decryptor  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_loop import make_train_step  # noqa: E402

MB = 2              # microbatches a step
HELD = 2            # experts held of the smoke config's 8


@pytest.fixture(autouse=True)
def _fresh():
    obs.clear()
    yield
    obs.clear()


def _cfg(remat=False):
    return dataclasses.replace(get_config("granite-4.0-h-small", smoke=True),
                               experts_held=HELD, expert_rank=1, remat=remat)


def _step(cfg, profiled: bool):
    """One encrypted train step of ``cfg`` on the CPU."""
    cipher = make_cipher("rubato-128l", seed=3, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (4, 32))
    model = M.init_params(cfg, seed=5, device="cpu").requires_grad_()
    opt = OptConfig()
    state = init_opt_state(model, opt)
    step = make_train_step(cfg, opt, microbatch=MB, device="cpu",
                           decryptor=make_decryptor(cipher))
    batch = encrypt_tokens(cipher, toks, 0)
    if not profiled:
        step(model, state, batch, 0)
        return
    with profile(activities=[ProfilerActivity.CPU]):
        step(model, state, batch, 0)


def test_off_without_a_profiler():
    _step(_cfg(), profiled=False)
    assert not obs.counting()
    obs.count("moe.routed", [1, 2])
    assert obs.records() == []


def test_one_set_a_step_under_a_profiler():
    cfg = _cfg()
    _step(cfg, profiled=True)
    recs = obs.records()
    n = Counter(r.name for r in recs)
    mamba = sum(s.kind == "mamba" for s in cfg.group)
    assert n["train.fwd_bwd"] == n["train.adamw"] == n["data.decrypt"] == 1
    assert n["ssm.scan"] == MB * mamba
    for name in ("moe.route", "moe.experts", "moe.shared", "moe.routed",
                 "moe.computed"):
        assert n[name] == MB * cfg.num_layers, name
    for r in recs:
        if r.name.startswith(("ssm.", "moe.")):
            assert r.under("train.fwd_bwd"), r.name
    assert not any(r.under("train.fwd_bwd") for r in recs
                   if r.name in ("train.adamw", "data.decrypt"))


def test_counters_hold_each_held_expert_and_drop_nothing():
    _step(_cfg(), profiled=True)
    routed = [r.value for r in obs.records() if r.name == "moe.routed"]
    computed = [r.value for r in obs.records() if r.name == "moe.computed"]
    assert routed == computed
    assert all(len(c) == HELD for c in computed)
    # 4 x 32 tokens, top-3 of 8: a held expert's share of the assignments
    assert 0 < sum(map(sum, computed)) <= MB * 10 * 64 * 3


def test_recompute_counts_once():
    """A checkpointed layer runs its forward twice (the recompute in the
    backward): the scan's span opens twice, the counters once."""
    cfg = _cfg(remat=True)
    _step(cfg, profiled=True)
    n = Counter(r.name for r in obs.records())
    mamba = sum(s.kind == "mamba" for s in cfg.group)
    assert n["ssm.scan"] == 2 * MB * mamba
    assert n["moe.computed"] == n["moe.routed"] == MB * cfg.num_layers


def test_a_counter_is_a_closed_record_inside_its_span():
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("outer"):
            obs.count("c", (3, 4))
    outer, c = obs.records()
    assert (c.name, c.value, c.start_ns) == ("c", [3, 4], c.end_ns)
    assert c.parent is outer and outer.value is None
