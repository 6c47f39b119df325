"""granite-4.0-h-small's plain reference against the port at the smoke
size on the CPU, in float32: logits, loss and gradients; the expert
shares adding up to the whole layer; dropless routing under a skewed
router; each muP multiplier; and the train cell's loop, run tiny, with
its faults caught."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hhebench import harness  # noqa: E402
from hhebench import train as loop  # noqa: E402
from hhebench.reference import granite_moe_hybrid as ref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402

CELL = "granite-4.0-h-small.encrypted-train-8k"
TOL = 2e-5          # float32 against float32, sums in other orders
TINY = dict(batch=4, seq_len=64, warm_steps=1, trace_steps=1,
            check_blocks_per_step=4, logit_positions=16,
            # the bf16 program's readings at this size: loss to 6e-6,
            # logits 0.004, the mixers' and shared expert's gradients
            # 0.009-0.011, the routed experts' 0.15 and the router's 0.38:
            # a near-tie of the router that bf16 flips moves a token of a
            # few dozen an expert
            limits={"loss_abs_err": 1e-3, "logits_rel_err": 0.05,
                    "grad_rel_err": dict.fromkeys(
                        ("mamba.w_out", "attention.wq", "experts.wo",
                         "shared.wo", "router"), 0.6)})


def _cfg(held=0, rank=0, **kw):
    c = get_config("granite-4.0-h-small", smoke=True)
    return dataclasses.replace(c, experts_held=held, expert_rank=rank, **kw)


def _file(mcfg) -> dict:
    """The benchmark's configuration file with the smoke widths."""
    cfg = json.loads((harness.HERE / "configs" / "granite-4.0-h-small.json")
                     .read_text())
    cfg.update({k: getattr(mcfg, f) for k, f in loop.FIELDS.items()})
    kinds = ["attention" if s.kind == "attn" else "mamba" for s in mcfg.group]
    cfg.update(smoke=True, num_local_experts=mcfg.held_experts[1],
               layer_types=kinds * mcfg.num_groups)
    return cfg


def _model(cfg, seed=0):
    """Weights from the seed, every leaf nudged so that the zero-initialised
    ones (norms, D) and the biases take part."""
    m = M.init_params(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for _, p in leaves_with_paths(m):
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    return m


def _tokens(cfg, B=2, T=64, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)))


def test_logits_and_loss_equal_the_reference():
    cfg = _cfg(held=2, rank=1, dtype="float32")
    m, toks = _model(cfg), _tokens(cfg)
    params = loop.ref_params(cfg, m.tree())
    for b in range(toks.shape[0]):
        got = M.forward_train(cfg, m, {"tokens": toks[b:b + 1]})[0][0]
        want, _ = ref.last_logits(_file(cfg), params, toks[b], toks.shape[1])
        assert ref.rel_err(got, want) < TOL
    labels = ref.next_labels(toks)
    got, _ = M.loss_fn(cfg, m, {"tokens": toks, "labels": labels})
    want = ref.microbatch_loss(_file(cfg), params, toks, 0.01)
    assert abs(float(got) - float(want)) < TOL


def test_gradients_equal_the_reference():
    cfg = _cfg(held=2, rank=3, dtype="float32")
    m, toks = _model(cfg).requires_grad_(), _tokens(cfg, B=4)
    wrt = {"mamba.w_out": (0, "w_out"), "attention.wq": (5, "wq"),
           "experts.wo": (7, "e_wo"), "shared.wo": (9, "s_wo"),
           "router": (2, "router"), "embed": (None, "embed"),
           "conv_bias": (1, "conv_x_b")}
    _, want = ref.step_loss_and_grads(
        _file(cfg), loop.ref_params(cfg, m.tree()),
        [toks[0::2], toks[1::2]], wrt, 0.01)
    paths = [p for p, _ in leaves_with_paths(m)]
    grads = [0] * len(paths)
    for mb in (toks[0::2], toks[1::2]):
        loss, _ = M.loss_fn(cfg, m, {"tokens": mb,
                                     "labels": ref.next_labels(mb)})
        gs = torch.autograd.grad(loss / 2, [t for _, t in
                                            leaves_with_paths(m)])
        grads = [a + b for a, b in zip(grads, gs)]
    by = dict(zip(paths, grads))
    for name, (i, key) in wrt.items():
        got = by[(key,)] if i is None else by[("blocks", i, key)][0]
        assert ref.rel_err(got, want[name]) < 1e-4, name


def test_the_chunked_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(2)
    T, H, P, S = 48, 3, 4, 5
    x, B, C = (torch.randn(T, *s, generator=g, dtype=torch.float64)
               for s in ((H, P), (S,), (S,)))
    dt = torch.rand(T, H, generator=g, dtype=torch.float64) * 2
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 16
    want = ref.sequential_ssd(x, dt, A, B, C)
    assert ref.rel_err(ref.ssd(x, dt, A, B, C, 16), want) < 1e-12


def test_a_long_chunk_backward_is_finite():
    """At the published widths a chunk's decay above the diagonal passes
    exp's float32 range; masked before the exp, the backward stays
    finite (and the port's too)."""
    from repro_torch.models import mamba2 as M2

    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 256, 2, 4, generator=g, requires_grad=True)
    dt = torch.full((1, 256, 2), 0.1)
    A = torch.tensor([-16.0, -1.0])
    B, C = torch.randn(2, 1, 256, 3, generator=g)
    y, _ = M2.ssd_chunked(x, dt, A, B, C, 256)
    (gx,) = torch.autograd.grad(y.square().sum(), x)
    assert torch.isfinite(gx).all()
    gy = ref.ssd(x[0], dt[0], A, B[0], C[0], 256)
    (gr,) = torch.autograd.grad(gy.square().sum(), x)
    assert torch.isfinite(gr).all() and ref.rel_err(gx, gr) < 1e-4


def _layer_params(cfg, m, i=0):
    return {k: v[0] for k, v in m.tree()["blocks"][i].items()}


def test_the_shares_add_up_to_the_whole_layer():
    """The 4 shares' FFN outputs of one layer, the shared expert counted
    once, add up to the uncut layer's, the program's and the reference's;
    each share's aux loss is the whole layer's."""
    full = _cfg(dtype="float32")
    whole = _layer_params(full, _model(full))
    x = torch.randn(2, 16, full.d_model, generator=torch.Generator()
                    .manual_seed(1))
    spec = full.group[0]
    want, aux = M._ffn_apply(full, spec, whole, x)
    shared = ref.swiglu(x, whole["s_wi_g"], whole["s_wi_u"], whole["s_wo"])
    parts = []
    for r in range(4):
        cfg = _cfg(held=2, rank=r, dtype="float32")
        p = dict(whole)
        for k in ("e_wi_g", "e_wi_u", "e_wo"):
            p[k] = whole[k][2 * r:2 * r + 2]
        y, a = M._ffn_apply(cfg, spec, p, x)
        assert float(a) == pytest.approx(float(aux), rel=1e-6)
        parts.append(y)
    got = sum(parts) - 3 * shared
    assert ref.rel_err(got, want) < TOL
    rcfg = _file(full)
    y_ref, _, _ = ref.moe(rcfg, whole, x.reshape(-1, full.d_model))
    y_ref = y_ref.reshape(x.shape) + shared
    assert ref.rel_err(got, y_ref) < TOL


def test_dropless_under_a_skewed_router():
    """A router that sends every token to held expert 0: every assignment
    is computed (the counters agree, the output is the reference's),
    where the capacity layer keeps 1.25 k / E of them."""
    cfg = _cfg(held=2, rank=0, dtype="float32")
    p = _layer_params(cfg, _model(cfg))
    p["router"] = p["router"].clone()
    p["router"][:, 0] += 50.0
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2)).abs()
    from torch.profiler import ProfilerActivity, profile

    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        y, _ = MOE.moe_ffn_held(cfg, x, p["router"], p["e_wi_g"],
                                p["e_wi_u"], p["e_wo"])
    (routed,) = [r.value for r in obs.records() if r.name == "moe.routed"]
    (done,) = [r.value for r in obs.records() if r.name == "moe.computed"]
    obs.clear()
    assert routed == done and done[0] == 32
    assert loop.dropped([]) == 0
    want, _, counted = ref.moe(_file(cfg), p, x.reshape(-1, cfg.d_model))
    assert counted == routed
    assert ref.rel_err(y.reshape(-1, cfg.d_model), want) < TOL
    # the capacity layer, on all 8 experts, drops past its capacity
    _, _, _, _, keep, cap = MOE.route(dataclasses.replace(
        cfg, experts_held=0, dropless=False), x.reshape(-1, cfg.d_model),
        p["router"])
    assert cap < 32 and int((~keep).sum()) > 0


def test_the_counters_find_a_dropped_assignment():
    Rec = obs.Record
    recs = [Rec("moe.routed", 0, 0, value=[3, 2]),
            Rec("moe.computed", 0, 0, value=[3, 1]),
            Rec("moe.routed", 0, 0, value=[4, 0])]
    assert loop.dropped(recs) == 1 + 4


@pytest.mark.parametrize("mult", ["embed_mult", "residual_mult",
                                  "logits_div", "attn_scale"])
def test_each_multiplier_moves_the_output_as_the_equations_say(mult):
    cfg = _cfg(held=2, dtype="float32")
    m = _model(cfg)
    toks = _tokens(cfg, B=1, T=32)
    one = dataclasses.replace(cfg, **{mult: 1.0})
    if mult == "embed_mult":
        x = M._embed_inputs(cfg, m, {"tokens": toks})
        assert torch.equal(x, 12 * M._embed_inputs(one, m, {"tokens": toks}))
    elif mult == "logits_div":
        got = M.forward_train(cfg, m, {"tokens": toks})[0]
        assert torch.equal(got * 16, M.forward_train(one, m,
                                                     {"tokens": toks})[0])
    elif mult == "residual_mult":
        # x + r * mixer(norm(x)), then + r * (moe + shared)(norm(x))
        p = _layer_params(cfg, m)
        x = torch.randn(1, 32, cfg.d_model, generator=torch.Generator()
                        .manual_seed(5))
        got, _, _ = M._block_apply(cfg, cfg.group[0], p, x, None, None)
        h = M.rms_norm(x, p["norm"], cfg.norm_eps)
        x1 = x + 0.22 * M._mamba_apply(cfg, p, h)[0]
        h = M.rms_norm(x1, p["norm2"], cfg.norm_eps)
        want = x1 + 0.22 * M._ffn_apply(cfg, cfg.group[0], p, h)[0]
        assert ref.rel_err(got, want) < 1e-6
    else:
        # the scores times attention_multiplier, not 1/sqrt(head_dim)
        g = torch.Generator().manual_seed(6)
        q = torch.randn(1, 32, 2, 2, 16, generator=g)
        k, v = torch.randn(2, 1, 32, 2, 16, generator=g)
        got = A.blockwise_attention(q, k, v, causal=True,
                                    scale=cfg.attn_scale)
        want = A.blockwise_attention(q * cfg.attn_scale * 4.0, k, v,
                                     causal=True)
        assert ref.rel_err(got, want) < 1e-6


# --- the cell's loop, tiny --------------------------------------------------
@pytest.fixture
def tiny_train(tmp_path):
    """run(**traffic) -> the result line of a tiny traced CPU run of the
    train cell, its configuration the smoke size with 2 of 8 experts
    held."""
    path = tmp_path / "granite-smoke.json"
    path.write_text(json.dumps(_file(_cfg(held=2, rank=1))))
    bench = harness.load_benchmark()
    for c in bench["configs"]:
        if c["name"] == "granite-4.0-h-small":
            c["file"] = str(path)

    def run(seed=2900000021, trace=True, control=None, **over):
        return harness.run_cell(CELL, seed, 0.3, trace, "cpu", control,
                                traffic_overrides={**TINY, **over},
                                bench=bench)

    return run


def test_tiny_run_is_correct(tiny_train):
    obs.clear()
    line = tiny_train()
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["metrics"]["moe.load_max_over_mean"]["value"] >= 1.0
    assert list(line)[-1] == "checks"
    obs.clear()


def test_control_reads_further_from_the_reference(tiny_train):
    a, b = tiny_train(trace=False)["checks"], tiny_train(
        trace=False, control="bf16")["checks"]
    assert b["loss_abs_err"]["value"] > 10 * a["loss_abs_err"]["value"]


def test_a_corrupted_token_is_caught(tiny_train, monkeypatch):
    from repro_torch.data import encrypted

    real = encrypted.make_decryptor

    def make(cipher, **kw):
        dec = real(cipher, **kw)

        def decrypt(batch):
            out = dec(batch)
            out["tokens"][0, 3] += 1
            return out
        return decrypt

    monkeypatch.setattr(encrypted, "make_decryptor", make)
    line = tiny_train(trace=False)
    assert not line["correct"] and line["failed"] > 0
    assert line["checks"]["wrong_tokens"]["value"] > 0


def test_a_wrong_gradient_is_caught(tiny_train, monkeypatch):
    from repro_torch.train.train_loop import TrainStep

    real = TrainStep._loss_and_grads

    def loss_and_grads(self, params, flat, batch):
        loss, grads = real(self, params, flat, batch)
        return loss, [g * 2 for g in grads]

    monkeypatch.setattr(TrainStep, "_loss_and_grads", loss_and_grads)
    line = tiny_train(trace=False)
    assert not line["correct"]
    assert line["checks"]["grad_rel_err.mamba.w_out"]["value"] > 0.9


def test_a_dropped_assignment_is_caught(tiny_train, monkeypatch):
    """A held-expert layer that keeps at most 3 rows an expert (a capacity
    planted in its groups) computes fewer rows than the router assigned:
    the counters see it, and the run is false."""
    real = MOE._held_groups

    def capped(key, held):
        sel, sizes = real(key, held)
        parts, at = [], 0
        for n in sizes:
            parts.append(sel[at:at + min(n, 3)])
            at += n
        return torch.cat(parts), [min(n, 3) for n in sizes]

    monkeypatch.setattr(MOE, "_held_groups", capped)
    line = tiny_train(trace=False)
    assert not line["correct"]
    assert line["checks"]["dropped_assignments"]["value"] > 0


def test_the_span_reader_counts_device_time_inside_spans():
    """Device time inside a span is the main stream's operations that ran
    while the span was open: idle time, and another stream's operations,
    do not count."""
    from types import SimpleNamespace

    from hhebench import program_spans
    from hhebench.trace import DeviceOp, Trace

    ops = [DeviceOp("gemm", 100, 200, 7), DeviceOp("gemm", 300, 450, 7),
           DeviceOp("aes", 120, 480, 9), DeviceOp("add", 600, 1000, 7)]
    run = SimpleNamespace(trace=Trace(ops, [], (0, 2000), 2, 0))
    obs.clear()
    obs._records.extend([obs.Record("moe.experts", 50, 400),
                         obs.Record("moe.experts", 350, 420),
                         obs.Record("ssm.scan", 500, 700),
                         obs.Record("moe.experts", 1500, 2500)])
    assert program_spans.main_stream(run.trace) == 7
    # (100..200) + (300..420); the span past the window is left out
    assert program_spans.ms_per_unit(run, "moe.experts") == pytest.approx(
        220e-6 / 2)
    assert program_spans.ms_per_unit(run, "ssm.scan") == pytest.approx(
        100e-6 / 2)
    assert program_spans.ms_per_unit(run, "train.adamw") is None
    obs.clear()


def test_a_program_without_the_configuration_fails_at_once(tiny_train,
                                                           monkeypatch):
    """The parent program has no granite-4.0-h-small: the run stops
    before any work, with an error."""
    from repro_torch.configs import base

    monkeypatch.setattr(base, "_REGISTRY", {k: v for k, v in
                                            base._REGISTRY.items()
                                            if k != "granite-4.0-h-small"})
    with pytest.raises(KeyError, match="unknown arch"):
        tiny_train()


def test_the_file_is_the_catalog_cut_as_reduced_says():
    bench = harness.load_benchmark()
    (entry,) = [c for c in bench["configs"]
                if c["name"] == "granite-4.0-h-small"]
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert set(entry["reduced"]) == {"num_hidden_layers", "layer_types",
                                     "num_local_experts"}
    assert (cfg["num_hidden_layers"], cfg["num_local_experts"]) == (10, 9)
    assert cfg["published"]["num_hidden_layers"] == 40
    assert cfg["experts_total"] == 72 and cfg["num_experts_per_tok"] == 10
    mcfg = loop.model_config(cfg)
    assert mcfg.held_experts == (0, 9) and mcfg.num_layers == 10
    assert mcfg.param_count() == pytest.approx(2.41e9, rel=0.01)
