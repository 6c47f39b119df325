"""The port's LLM modules (``repro_torch.models``) against the JAX reference
on the CPU, at smoke widths.

Inputs come from numpy seeds and go to both packages; parameters cross by
``params_from_reference``.  Tolerances: float32 1e-4 max abs (sums run in
another order than XLA's); bf16 5e-2 max abs, but for gemma2-9b's hidden
states (:data:`HIDDEN_TOL`); routing (expert indices, capacity positions,
drops) and the weight converter are exact.

gemma2-9b's hidden states reach 6.6 (the sqrt(d) embedding scale and the
sandwich norms), where a bf16 ulp is 2**-5.  The two frameworks round bf16
at other places, and so does the reference itself between its compiled
group scan and the same layers run op by op (0.0625 there).  The port
reads 0.078 (2.5 ulps); the bound is 4 ulps, 0.125, and a sliding window
off by one reads 0.906.  The reference side of each arch is computed once
per module (its compiles are the cost).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.configs.base import list_archs as ref_list_archs  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import mamba2 as RM2  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402

from repro_torch.configs import base as CB  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_reference,
    params_to_numpy,
)

#: the architectures the reference holds (the port adds its own beside them)
ARCHS = ref_list_archs()
CAUSAL = [a for a in ARCHS if get_config(a, smoke=True).causal]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
HIDDEN_TOL = {("gemma2-9b", "bfloat16"): 0.125}   # see the module note
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _j(a, dt="float32"):
    return jnp.asarray(np.asarray(a, np.float32), JDT[dt])


def _t(a, dt="float32"):
    return torch.as_tensor(np.asarray(a, np.float32)).to(TDT[dt])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err <= tol, err
    return err


def _ref_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(arch, smoke):
    """Every field the reference has is equal; each port-only field holds
    its neutral default."""
    c, r = get_config(arch, smoke), ref_get_config(arch, smoke)
    got, want = dataclasses.asdict(c), dataclasses.asdict(r)
    assert {k: got[k] for k in want} == want
    neutral = {f.name: f.default for f in dataclasses.fields(CB.ModelConfig)
               if f.name not in want}
    assert neutral and {k: got[k] for k in neutral} == neutral
    assert c.param_count() == r.param_count()
    assert c.active_param_count() == r.active_param_count()
    for prop in ("resolved_head_dim", "num_groups", "vocab_padded",
                 "d_inner", "ssm_heads", "conv_dim"):
        assert getattr(c, prop) == getattr(r, prop), prop


def test_registry_is_the_reference_and_the_port_only_archs():
    assert list_archs() == sorted(ref_list_archs() + ["granite-4.0-h-small"])


def test_config_registry_rejects_an_unknown_arch():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    with pytest.raises(ValueError, match="not divisible"):
        CB.ModelConfig(name="x", family="dense", num_layers=3, d_model=8,
                       num_heads=2, kv_heads=2, d_ff=8, vocab=8,
                       group=(CB.LayerSpec(), CB.LayerSpec()))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rms_norm(dt):
    rng = np.random.default_rng(1)
    x, s = rng.normal(0, 2, (3, 5, 48)), rng.normal(0, 0.5, (48,))
    got = L.rms_norm(_t(x, dt), _t(s), 1e-5)
    want = RL.rms_norm(_j(x, dt), _j(s), 1e-5)
    assert got.dtype == TDT[dt]
    _close(got, want, TOL[dt] / 10)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_gated_mlp_one_shot(dt):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 7, 32))
    g, u, o = (rng.normal(0, 0.2, s) for s in ((32, 48), (32, 48), (48, 32)))
    got = L.gated_mlp(_t(x, dt), _t(g, dt), _t(u, dt), _t(o, dt))
    want = RL.gated_mlp(_j(x, dt), _j(g, dt), _j(u, dt), _j(o, dt))
    _close(got, want, TOL[dt])


def _ref_chunked(x, wi_g, wi_u, wo):
    """The reference's F-chunked branch (`repro/models/layers.py:45-66`),
    which it takes only above 2**27 weight elements and 1024 tokens — too
    large for a CPU test — run here at a small width."""
    F_ = wi_g.shape[1]
    n_chunks = 4
    while F_ % n_chunks:
        n_chunks //= 2

    def chunk(acc, ws):
        g, u, o = ws
        h = jax.nn.silu(jnp.einsum("...d,df->...f", x, g)) * jnp.einsum(
            "...d,df->...f", x, u)
        return acc + jnp.einsum("...f,fd->...d", h, o).astype(acc.dtype), None

    split = lambda w, ax: jnp.stack(jnp.split(w, n_chunks, axis=ax))  # noqa: E731
    acc, _ = jax.lax.scan(chunk, jnp.zeros(x.shape, jnp.float32),
                          (split(wi_g, 1), split(wi_u, 1), split(wo, 0)))
    return acc.astype(x.dtype)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("F_", [48, 6])     # 4 chunks, and 2 (6 % 4 != 0)
def test_gated_mlp_chunked_path(dt, F_):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (3, 5, 16))
    g, u, o = (rng.normal(0, 0.3, s) for s in ((16, F_), (16, F_), (F_, 16)))
    got = L.chunked_gated_mlp(_t(x, dt), _t(g, dt), _t(u, dt), _t(o, dt))
    want = _ref_chunked(_j(x, dt), _j(g, dt), _j(u, dt), _j(o, dt))
    assert got.dtype == TDT[dt]
    _close(got, want, TOL[dt])
    if dt == "float32":     # same sums, another order: within float32 noise
        one = L.gated_mlp(_t(x), _t(g), _t(u), _t(o))
        _close(got, one, 1e-5)


@pytest.mark.parametrize("tokens,D,F_,chunked", [
    (1025, 8192, 16400, True),      # both thresholds passed
    (1024, 8192, 16400, False),     # few tokens: one shot
    (4096, 4096, 12800, False),     # granite-3-8b's FFN: below 2**27
])
def test_gated_mlp_takes_the_chunked_path_where_the_reference_does(
        monkeypatch, tokens, D, F_, chunked):
    calls = []
    monkeypatch.setattr(L, "chunked_gated_mlp",
                        lambda *a: calls.append(a) or a[0])
    monkeypatch.setattr(L, "_swiglu", lambda x, *a: x)
    meta = torch.device("meta")
    x = torch.empty((tokens, D), device=meta)
    L.gated_mlp(x, torch.empty((D, F_), device=meta),
                torch.empty((D, F_), device=meta),
                torch.empty((F_, D), device=meta))
    assert bool(calls) == chunked


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,mrope_pos", [("granite-3-8b", False),
                                            ("internlm2-20b", False),
                                            ("qwen2-vl-7b", False),
                                            ("qwen2-vl-7b", True)])
def test_rope(arch, mrope_pos):
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(4)
    B, T, hd = 2, 9, cfg.resolved_head_dim
    shape = (B, T, 3) if mrope_pos else (B, T)
    pos = rng.integers(0, 4000, shape)
    cos, sin = A.rope_angles(cfg, torch.as_tensor(pos))
    rcos, rsin = RA.rope_angles(ref_get_config(arch, True),
                                jnp.asarray(pos, jnp.int32))
    _close(cos, rcos, 1e-5)
    _close(sin, rsin, 1e-5)
    x = rng.normal(0, 1, (B, T, 3, hd))
    for dt in ("float32", "bfloat16"):
        got = A.apply_rope(_t(x, dt), cos, sin)
        want = RA.apply_rope(_j(x, dt), rcos, rsin)
        assert got.dtype == TDT[dt]
        _close(got, want, TOL[dt] / 5)


ATTN_CASES = [
    # causal, window, softcap, T, q_chunk, k_chunk
    (True, 0, 0.0, 32, 0, 0),
    (True, 0, 0.0, 32, 8, 8),
    (True, 0, 0.0, 32, 16, 8),
    (True, 8, 0.0, 64, 16, 16),
    (True, 5, 0.0, 32, 8, 4),
    (True, 0, 50.0, 32, 8, 16),
    (True, 16, 30.0, 48, 16, 8),
    (False, 0, 0.0, 32, 8, 8),
    (False, 0, 0.0, 24, 0, 0),
]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,softcap,T,qc,kc", ATTN_CASES)
def test_blockwise_attention(dt, causal, window, softcap, T, qc, kc):
    rng = np.random.default_rng(5)
    B, K, G, hd = 2, 2, 2, 16
    q = rng.normal(0, 1, (B, T, K, G, hd))
    k, v = (rng.normal(0, 1, (B, T, K, hd)) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=qc,
              k_chunk=kc)
    got = A.blockwise_attention(_t(q, dt), _t(k, dt), _t(v, dt), **kw)
    want = RA.blockwise_attention(_j(q, dt), _j(k, dt), _j(v, dt), **kw)
    assert got.dtype == TDT[dt] and got.shape == (B, T, K, G, hd)
    _close(got, want, TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur_len,window,softcap", [
    (1, 0, 0.0), (9, 0, 0.0), (20, 4, 0.0), (20, 0, 50.0), (24, 6, 30.0)])
def test_decode_attention(dt, cur_len, window, softcap):
    rng = np.random.default_rng(6)
    B, S, K, G, hd = 2, 24, 2, 3, 8
    q = rng.normal(0, 1, (B, 1, K, G, hd))
    kc, vc = (rng.normal(0, 1, (B, S, K, hd)) for _ in range(2))
    kw = dict(window=window, softcap=softcap)
    got = A.decode_attention(_t(q, dt), _t(kc, dt), _t(vc, dt), cur_len, **kw)
    want = RA.decode_attention(_j(q, dt), _j(kc, dt), _j(vc, dt),
                               jnp.asarray(cur_len, jnp.int32), **kw)
    _close(got, want, TOL[dt])


# ---------------------------------------------------------------------------
# mamba2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_causal_conv_and_conv_decode(dt):
    rng = np.random.default_rng(7)
    B, T, C, W = 2, 11, 12, 4
    u, w = rng.normal(0, 1, (B, T, C)), rng.normal(0, 0.5, (W, C))
    _close(M2.causal_conv(_t(u, dt), _t(w, dt)),
           RM2.causal_conv(_j(u, dt), _j(w, dt)), TOL[dt])
    state = rng.normal(0, 1, (B, W - 1, C))
    y, ns = M2.conv_decode(_t(u[:, 0], dt), _t(state, dt), _t(w, dt))
    ry, rns = RM2.conv_decode(_j(u[:, 0], dt), _j(state, dt), _j(w, dt))
    _close(y, ry, TOL[dt])
    _close(ns, rns, 0.0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,chunk,with_h0", [(16, 16, False), (32, 8, False),
                                             (24, 8, True), (12, 64, True)])
def test_ssd_chunked(dt, T, chunk, with_h0):
    rng = np.random.default_rng(8)
    B, H, P, S = 2, 3, 4, 5
    x = rng.normal(0, 1, (B, T, H, P))
    dtv = rng.uniform(0.001, 0.2, (B, T, H))
    Aneg = -rng.uniform(1, 16, (H,))
    Bm, Cm = rng.normal(0, 1, (B, T, S)), rng.normal(0, 1, (B, T, S))
    h0 = rng.normal(0, 1, (B, H, P, S)) if with_h0 else None
    y, h = M2.ssd_chunked(_t(x, dt), _t(dtv), _t(Aneg), _t(Bm, dt),
                          _t(Cm, dt), chunk,
                          h0=None if h0 is None else _t(h0))
    ry, rh = RM2.ssd_chunked(_j(x, dt), _j(dtv), _j(Aneg), _j(Bm, dt),
                             _j(Cm, dt), chunk,
                             h0=None if h0 is None else _j(h0))
    assert y.dtype == TDT[dt] and h.dtype == torch.float32
    _close(y, ry, TOL[dt])
    _close(h, rh, 1e-4 if dt == "float32" else TOL[dt])


def test_ssd_decode_continues_ssd_chunked():
    rng = np.random.default_rng(9)
    B, H, P, S = 2, 3, 4, 5
    x, h = rng.normal(0, 1, (B, H, P)), rng.normal(0, 1, (B, H, P, S))
    dtv, Aneg = rng.uniform(0.001, 0.2, (B, H)), -rng.uniform(1, 16, (H,))
    Bt, Ct = rng.normal(0, 1, (B, S)), rng.normal(0, 1, (B, S))
    y, hn = M2.ssd_decode(_t(x), _t(dtv), _t(Aneg), _t(Bt), _t(Ct), _t(h))
    ry, rhn = RM2.ssd_decode(_j(x), _j(dtv), _j(Aneg), _j(Bt), _j(Ct), _j(h))
    _close(y, ry, 1e-5)
    _close(hn, rhn, 1e-5)


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor,drops", [(4.0, False),
                                                   (0.5, True)])
def test_moe_ffn_routing_drops_and_output(dt, capacity_factor, drops):
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              capacity_factor=capacity_factor)
    rcfg = dataclasses.replace(ref_get_config("mixtral-8x7b", True),
                               capacity_factor=capacity_factor)
    E, k, D, F_ = cfg.num_experts, cfg.top_k, cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(10)
    B, T = 2, 24
    x = rng.normal(0, 1, (B, T, D))
    router = rng.normal(0, 0.5, (D, E))
    wg, wu = (rng.normal(0, 0.1, (E, D, F_)) for _ in range(2))
    wo = rng.normal(0, 0.1, (E, F_, D))

    # routing: the reference's top-k and its sort-based positions
    xt = _t(x, dt)
    _, gates, e_slot, pos, keep, cap = MOE.route(cfg, xt.reshape(-1, D),
                                                 _t(router))
    xj = _j(x, dt).reshape(-1, D)
    probs = jax.nn.softmax(jnp.einsum("nd,de->ne", xj.astype(jnp.float32),
                                      _j(router)), axis=-1)
    rg, reidx = jax.lax.top_k(probs, k)
    rcap = max(1, int(np.ceil(B * T * k * capacity_factor / E)))
    rpos, rkeep = RMOE._local_positions(reidx, k, B * T, E, rcap)
    assert cap == rcap
    np.testing.assert_array_equal(e_slot.numpy(), np.asarray(reidx).T)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    assert bool((~keep).any()) == drops

    y, aux = MOE.moe_ffn(cfg, xt, _t(router), _t(wg, dt), _t(wu, dt),
                         _t(wo, dt))
    ry, raux = RMOE.moe_ffn(rcfg, _j(x, dt), _j(router), _j(wg, dt),
                            _j(wu, dt), _j(wo, dt))
    assert y.dtype == TDT[dt]
    _close(y, ry, TOL[dt])
    _close(aux, raux, 1e-5)


# ---------------------------------------------------------------------------
# whole models: weights carried across
# ---------------------------------------------------------------------------
def _cfgs(arch, dt):
    return (dataclasses.replace(get_config(arch, True), dtype=dt),
            dataclasses.replace(ref_get_config(arch, True), dtype=dt))


def _batch(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.causal:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, T))
    else:
        out["embeds"] = rng.normal(0, 1, (B, T, cfg.frontend_dim))
    return out


def _to_ref(batch):
    return {k: (jnp.asarray(v, jnp.int32) if v.dtype.kind == "i"
                else jnp.asarray(v, jnp.float32)) for k, v in batch.items()}


def _to_port(batch):
    return {k: (torch.as_tensor(v, dtype=torch.int64) if v.dtype.kind == "i"
                else torch.as_tensor(v, dtype=torch.float32))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg = ref_get_config(arch, True)
            cache[arch] = _ref_np(RM.init_params(rcfg, jax.random.key(7)))
        return cache[arch]
    return get


@pytest.fixture(scope="module")
def ref_forward(ref_params):
    cache = {}

    def get(arch, dt):
        if (arch, dt) not in cache:
            _, rcfg = _cfgs(arch, dt)
            batch = _to_ref(_batch(rcfg, 2, 32, seed=11))
            params = jax.tree.map(jnp.asarray, ref_params(arch))
            hidden, aux = RM.forward_hidden(rcfg, params, batch)
            logits, _ = RM.forward_train(rcfg, params, batch)
            cache[arch, dt] = (np.asarray(hidden.astype(jnp.float32)),
                               np.asarray(logits), float(aux))
        return cache[arch, dt]
    return get


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_the_reference(arch, dt, ref_params,
                                             ref_forward):
    cfg, _ = _cfgs(arch, dt)
    model = params_from_reference(cfg, ref_params(arch), device="cpu")
    batch = _to_port(_batch(cfg, 2, 32, seed=11))
    hidden, aux = M.forward_hidden(cfg, model, batch)
    logits, _ = M.forward_train(cfg, model, batch)
    rh, rl, raux = ref_forward(arch, dt)
    assert logits.shape == (2, 32, cfg.vocab_padded)
    assert logits.dtype == torch.float32 and hidden.dtype == TDT[dt]
    _close(hidden, rh, HIDDEN_TOL.get((arch, dt), TOL[dt]))
    _close(logits, rl, TOL[dt])
    assert abs(float(aux) - raux) <= TOL[dt] / 10


def test_gemma2_bf16_hidden_bound_rejects_a_window_off_by_one(ref_params,
                                                              ref_forward):
    """HIDDEN_TOL is loose enough for bf16 rounding, not for a fault: the
    port with every sliding window one shorter misses it."""
    cfg, _ = _cfgs("gemma2-9b", "bfloat16")
    assert any(spec.window for spec in cfg.group)
    cfg = dataclasses.replace(cfg, group=tuple(
        dataclasses.replace(spec, window=max(spec.window - 1, 0))
        for spec in cfg.group))
    model = params_from_reference(cfg, ref_params("gemma2-9b"), device="cpu")
    hidden, _ = M.forward_hidden(cfg, model,
                                 _to_port(_batch(cfg, 2, 32, seed=11)))
    rh = ref_forward("gemma2-9b", "bfloat16")[0]
    err = float(np.abs(_np(hidden) - rh).max())
    assert err > HIDDEN_TOL["gemma2-9b", "bfloat16"], err


@pytest.fixture(scope="module")
def ref_serve(ref_params):
    cache = {}

    def get(arch, dt):
        if (arch, dt) not in cache:
            _, rcfg = _cfgs(arch, dt)
            params = jax.tree.map(jnp.asarray, ref_params(arch))
            toks = _batch(rcfg, 2, 19, seed=12)["tokens"]
            lg, c, cur = RM.prefill(rcfg, params,
                                    {"tokens": jnp.asarray(toks[:, :16],
                                                           jnp.int32)}, 24)
            outs = [np.asarray(lg)]
            for i in range(3):
                cur = cur + 1
                lg, c = RM.decode_step(
                    rcfg, params, c,
                    jnp.asarray(toks[:, 16 + i:17 + i], jnp.int32), cur)
                outs.append(np.asarray(lg))
            cache[arch, dt] = (toks, outs)
        return cache[arch, dt]
    return get


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", CAUSAL)
def test_prefill_and_decode_match_the_reference(arch, dt, ref_params,
                                                ref_serve):
    cfg, _ = _cfgs(arch, dt)
    model = params_from_reference(cfg, ref_params(arch), device="cpu")
    toks, ref_outs = ref_serve(arch, dt)
    t = torch.as_tensor(toks, dtype=torch.int64)
    lg, cache, cur = M.prefill(cfg, model, {"tokens": t[:, :16]}, 24)
    assert cur == 16 and lg.shape == (2, 1, cfg.vocab_padded)
    outs = [lg]
    for i in range(3):
        cur += 1
        lg, cache2 = M.decode_step(cfg, model, cache, t[:, 16 + i:17 + i],
                                   cur)
        assert cache2 is cache          # updated in place
        outs.append(lg)
    for got, want in zip(outs, ref_outs):
        _close(got, want, TOL[dt])


@pytest.mark.parametrize("arch", CAUSAL)
def test_decode_matches_teacher_forcing(arch, ref_params):
    """The port's own consistency, in float32 (the reference's
    `test_decode_matches_teacher_forcing`): prefill + 3 decode steps
    against one forward over all the tokens."""
    cfg, _ = _cfgs(arch, "float32")
    model = params_from_reference(cfg, ref_params(arch), device="cpu")
    toks = torch.as_tensor(_batch(cfg, 2, 20, seed=13)["tokens"])
    full, _ = M.forward_train(cfg, model, {"tokens": toks})
    lg, cache, cur = M.prefill(cfg, model, {"tokens": toks[:, :16]}, 24)
    errs = [float((lg[:, 0] - full[:, 15]).abs().max())]
    for i in range(3):
        cur += 1
        lg, cache = M.decode_step(cfg, model, cache, toks[:, 16 + i:17 + i],
                                  cur)
        errs.append(float((lg[:, 0] - full[:, 16 + i]).abs().max()))
    # MoE: token-choice capacity differs between a batched prompt and one
    # token (a real semantic effect); the reference's own tolerance
    assert max(errs) < (6e-2 if cfg.num_experts else 1e-4), errs


# ---------------------------------------------------------------------------
# converter, serving cast, init
# ---------------------------------------------------------------------------
def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_round_trip_is_bit_exact(arch, ref_params):
    cfg = get_config(arch, True)
    tree = ref_params(arch)
    model = params_from_reference(cfg, tree, device="cpu")
    back = params_to_numpy(model)
    flat_ref = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], _bits(leaf),
                                      err_msg=str(path))
    again = params_to_numpy(params_from_reference(cfg, back, device="cpu"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(again)[0]:
        np.testing.assert_array_equal(leaf, flat_back[path])


def test_converter_rejects_a_wrong_shape(ref_params):
    cfg = get_config("granite-3-8b", True)
    tree = dict(ref_params("granite-3-8b"))
    tree["final_norm"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_once_equals_cast_per_use(arch, ref_params):
    """The serving model's once-cast weights give bit-equal logits."""
    cfg = get_config(arch, True)           # compute bf16
    master = params_from_reference(cfg, ref_params(arch), device="cpu")
    served = params_from_reference(cfg, ref_params(arch),
                                   device="cpu").cast_for_serving()
    for path, d in M.iter_defs(cfg):
        want = (torch.float32 if d.dtype == "float32" else torch.bfloat16)
        assert served.tensor(path).dtype == want, path
    batch = _to_port(_batch(cfg, 2, 16, seed=14))
    a, _ = M.forward_train(cfg, master, batch)
    b, _ = M.forward_train(cfg, served, batch)
    assert torch.equal(a, b)
    if cfg.causal:
        t = batch["tokens"]
        la, ca, cur = M.prefill(cfg, master, {"tokens": t[:, :12]}, 16)
        lb, cb, _ = M.prefill(cfg, served, {"tokens": t[:, :12]}, 16)
        assert torch.equal(la, lb)
        la, _ = M.decode_step(cfg, master, ca, t[:, 12:13], cur + 1)
        lb, _ = M.decode_step(cfg, served, cb, t[:, 12:13], cur + 1)
        assert torch.equal(la, lb)
    assert served.weight_bytes() < master.weight_bytes() or \
        cfg.param_dtype == "bfloat16"


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_dtypes_and_count(arch):
    cfg = get_config(arch, True)
    model = M.init_params(cfg, seed=0, device="cpu")
    ref_defs = RM.param_defs(ref_get_config(arch, True))
    for path, d in M.iter_defs(cfg):
        node = ref_defs
        for key in path:
            node = node[key]
        assert (d.shape, d.role, d.scale, d.dtype, d.init) == (
            node.shape, node.role, node.scale, node.dtype, node.init), path
        t = model.tensor(path)
        assert tuple(t.shape) == d.shape
        assert t.dtype == M.param_dtype(cfg, d)
        if d.init == "zeros":
            assert not t.any()
    actual = sum(p.numel() for p in model.parameters())
    assert abs(actual - cfg.param_count()) / actual < 0.02
    again = M.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


def test_init_params_distributions():
    cfg = get_config("jamba-1.5-large", True)
    model = M.init_params(cfg, seed=3, device="cpu")
    mamba = model["blocks"][0]
    dt_bias = torch.nn.functional.softplus(mamba["dt_bias"])
    assert float(dt_bias.min()) >= 1e-3 * 0.999
    assert float(dt_bias.max()) <= 1e-1 * 1.001
    a = torch.exp(mamba["A_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    wq = model["blocks"][3]["wq"].float()
    assert abs(float(wq.std()) - 0.02) < 0.004
    wo = model["blocks"][3]["wo"].float()
    assert abs(float(wo.std()) - 0.02 / np.sqrt(2 * cfg.num_layers)) < 0.002


def test_encoder_arch_is_bidirectional_and_causal_ignores_future(ref_params):
    cfg = get_config("hubert-xlarge", True)
    model = params_from_reference(cfg, ref_params("hubert-xlarge"),
                                  device="cpu")
    e = torch.randn(1, 16, cfg.frontend_dim, generator=torch.Generator()
                    .manual_seed(0))
    l1, _ = M.forward_train(cfg, model, {"embeds": e})
    e2 = e.clone()
    e2[:, -1] += 10.0
    l2, _ = M.forward_train(cfg, model, {"embeds": e2})
    assert float((l1[:, 0] - l2[:, 0]).abs().max()) > 1e-4
    cfg = get_config("deepseek-7b", True)
    model = params_from_reference(cfg, ref_params("deepseek-7b"),
                                  device="cpu")
    t1 = torch.randint(0, cfg.vocab, (1, 16),
                       generator=torch.Generator().manual_seed(0))
    t2 = t1.clone()
    t2[:, -1] = (t2[:, -1] + 7) % cfg.vocab
    l1, _ = M.forward_train(cfg, model, {"tokens": t1})
    l2, _ = M.forward_train(cfg, model, {"tokens": t2})
    torch.testing.assert_close(l1[:, :-1], l2[:, :-1], atol=1e-5, rtol=0)


def test_frontend_embeds_and_mrope_positions_match_the_reference(ref_params):
    """qwen2-vl's vision path: patch embeddings through frontend_proj with
    explicit (B, T, 3) M-RoPE positions."""
    arch = "qwen2-vl-7b"
    cfg, rcfg = _cfgs(arch, "float32")
    model = params_from_reference(cfg, ref_params(arch), device="cpu")
    rng = np.random.default_rng(15)
    e = rng.normal(0, 1, (2, 16, cfg.frontend_dim))
    pos = rng.integers(0, 64, (2, 16, 3))
    got, _ = M.forward_train(cfg, model, {
        "embeds": torch.as_tensor(e, dtype=torch.float32),
        "positions": torch.as_tensor(pos)})
    want, _ = RM.forward_train(rcfg, jax.tree.map(jnp.asarray,
                                                  ref_params(arch)), {
        "embeds": jnp.asarray(e, jnp.float32),
        "positions": jnp.asarray(pos, jnp.int32)})
    _close(got, want, 1e-4)
