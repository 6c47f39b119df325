"""The port's training path (``repro_torch.data.pipeline``,
``repro_torch.train``, ``loss_fn`` and remat in ``repro_torch.models.model``,
``repro_torch.launch.{elastic,train}``) against the JAX reference on the
CPU, at smoke widths.

Inputs come from numpy seeds and go to both packages; parameters cross by
``params_from_reference``.  Tolerances:

* data batches, plan_mesh, the watchdog, checkpoints and the int8
  moments: exact;
* lr, global_norm and AdamW parameters over 5 steps on identical
  gradients: 1e-6 relative (float32 sums in another order);
* ``loss_fn`` in float32 compute: 1e-5 relative; every parameter's
  gradient within 1e-4 of that leaf's largest reference gradient; bf16
  compute: 5e-2 (loss and gradients alike, relative);
* the train step over 3 steps (float32 compute): loss, grad_norm and lr
  within 1e-4 relative at each step.

The reference side of each arch's gradients is computed once per module
(its compiles are the cost).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.core.cipher import make_cipher as ref_make_cipher  # noqa: E402
from repro.data import encrypted as RE  # noqa: E402
from repro.data import pipeline as RP  # noqa: E402
from repro.launch import elastic as REL  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models.sharding import make_policy  # noqa: E402
from repro.train import checkpoint as RCK  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train.train_loop import make_train_step as ref_train_step  # noqa: E402

from repro.configs.base import list_archs as ref_list_archs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.cipher import make_cipher  # noqa: E402
from repro_torch.data import encrypted as E  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.launch import elastic as EL  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train.train_loop import make_train_step  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the architectures the reference holds (the port adds its own beside them)
ARCHS = ref_list_archs()


def _name(path):
    return "_".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _ref_named(tree):
    return {_name(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_named(tree):
    return {"_".join(map(str, p)): leaf for p, leaf in leaves_with_paths(tree)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bits(x):
    """Raw element bits (bf16 as uint16), so comparisons are bit-exact."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,seed", [("granite-3-8b", 0),
                                       ("deepseek-7b", 7)])
def test_synthetic_lm_batches_equal_the_reference(arch, seed):
    src = P.make_source(get_config(arch, smoke=True), 3, 24, seed=seed)
    ref = RP.make_source(ref_get_config(arch, True), 3, 24, seed=seed)
    assert isinstance(src, P.SyntheticLM)
    for step in (0, 1, 5, 1000):
        got, want = src.batch_at(step), ref.batch_at(step)
        assert sorted(got) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    first = [b["tokens"] for _, b in zip(range(3), src)]
    for step, toks in enumerate(first):
        np.testing.assert_array_equal(toks, ref.batch_at(step)["tokens"])


def test_token_file_batches_equal_the_reference(tmp_path):
    path = tmp_path / "toks.bin"
    np.random.default_rng(3).integers(0, 500, 4000).astype(np.uint16) \
        .tofile(path)
    cfg = get_config("granite-3-8b", smoke=True)
    src = P.make_source(cfg, 4, 16, path=str(path))
    ref = RP.make_source(ref_get_config("granite-3-8b", True), 4, 16,
                         path=str(path))
    assert isinstance(src, P.TokenFile)
    for step in (0, 3, 17):
        got, want = src.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])


def test_iterate_batches_prefers_a_sources_stream():
    class Both:
        def batch_at(self, step):
            return ("batch_at", step)

        def stream(self, start, n):
            return iter([("stream", start, n)])

    src = P.SyntheticLM(get_config("granite-3-8b", smoke=True), 2, 8)
    assert list(P.iterate_batches(Both(), 4, 2)) == [("stream", 4, 2)]
    got = list(P.iterate_batches(src, 2, 3))
    assert len(got) == 3
    for step, b in zip(range(2, 5), got):
        np.testing.assert_array_equal(b["tokens"], src.batch_at(step)["tokens"])
    assert P.PipelineState().step == 0


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(100, 10000), (5, 3), (0, 50)])
def test_lr_at_matches_the_reference(warmup, total):
    opt = O.OptConfig(warmup_steps=warmup, total_steps=total)
    ref = RO.OptConfig(warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 4, 5, 99, 100, 2500, 9999, 20000):
        want = float(RO.lr_at(ref, jnp.asarray(step, jnp.int32)))
        assert abs(O.lr_at(opt, step) - want) <= 1e-6 * want, step


def _opt_tree(rng):
    """Leaves of every kind: a stacked (G, D, F) leaf, a matrix, small
    vectors (float32 moments even when 8-bit), and a bf16 master."""
    return {"blocks": [{"w": rng.normal(0, 1, (4, 32, 48)),
                        "norm": rng.normal(0, 1, (4, 16))}],
            "embed": rng.normal(0, 1, (96, 64)),
            "final_norm": rng.normal(0, 1, (64,)),
            "head_bf16": rng.normal(0, 1, (64, 96))}


def _to_ref_tree(tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, jnp.bfloat16 if "bf16" in _name(p)
                                 else jnp.float32), tree)


def _to_port_tree(tree):
    def conv(path, a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(
            torch.bfloat16 if "bf16" in _name(path) else torch.float32)
    return jax.tree_util.tree_map_with_path(conv, tree)


@pytest.mark.parametrize("threshold", [1 << 27, 1000])
def test_global_norm_matches_the_reference(monkeypatch, threshold):
    monkeypatch.setattr(O, "CHUNK_ELEMS", threshold)
    tree = _opt_tree(np.random.default_rng(1))
    assert O._chunked(torch.zeros(4, 32, 48)) == (threshold == 1000)
    got = O.global_norm(_to_port_tree(tree))
    want = RO.global_norm(_to_ref_tree(tree))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("eightbit,grad_clip", [(False, 1e9), (True, 1e9),
                                                (False, 3.0)])
@pytest.mark.parametrize("threshold", [1 << 27, 1000])
def test_adamw_matches_the_reference_over_five_steps(monkeypatch, eightbit,
                                                     threshold, grad_clip):
    """Identical gradients each step; the 1000-element threshold updates
    the stacked leaf and the matrix a run of rows at a time.  The clip
    engages only with float32 moments: it divides by a float32 global norm
    summed in another order than XLA's, so an int8 code at a rounding tie
    could move by one and the exact check would not hold."""
    monkeypatch.setattr(O, "CHUNK_ELEMS", threshold)
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=grad_clip,
              warmup_steps=2, total_steps=20, eightbit=eightbit)
    opt, ropt = O.OptConfig(**kw), RO.OptConfig(**kw)
    rng = np.random.default_rng(2)
    tree = _opt_tree(rng)
    p, rp = _to_port_tree(tree), _to_ref_tree(tree)
    s, rs = O.init_opt_state(p, opt), RO.init_opt_state(rp, ropt)
    assert sorted(_port_named(s)) == sorted(_ref_named(rs))
    for name, leaf in _port_named(s).items():
        assert str(leaf.dtype).split(".")[1] == str(
            _ref_named(rs)[name].dtype), name
    for step in range(5):
        g = {k: v for k, v in _opt_tree(rng).items()}
        g = jax.tree.map(lambda a: a * 2.0, g)
        p, s, m = O.adamw_update(p, _to_port_tree(g), s, step, opt)
        rp, rs, rm = RO.adamw_update(rp, _to_ref_tree(g), rs,
                                     jnp.asarray(step, jnp.int32), ropt)
        assert _rel(m["grad_norm"], rm["grad_norm"]) <= 1e-6
        assert abs(m["lr"] - float(rm["lr"])) <= 1e-6 * float(rm["lr"])
        for name, want in _ref_named(rp).items():
            got = _port_named(p)[name]
            assert _rel(got, want) <= 1e-6, (step, name)
        for name, want in _ref_named(rs).items():
            got = _port_named(s)[name]
            if want.dtype == np.int8:
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{step} {name}")
            else:
                assert _rel(got, want) <= 1e-6, (step, name)
    if eightbit:
        assert _port_named(s)["blocks_0_w_m_q"].dtype == torch.int8
        assert "final_norm_m" in _port_named(s)


def test_adamw_clip_engages_and_updates_in_place():
    opt = O.OptConfig(lr=1.0, grad_clip=0.1, weight_decay=0.0,
                      warmup_steps=0, total_steps=10**9)
    w = torch.ones(4)
    p = {"w": w}
    s = O.init_opt_state(p, opt)
    p2, s2, m = O.adamw_update(p, {"w": torch.full((4,), 100.0)}, s, 0, opt)
    assert float(m["grad_norm"]) == pytest.approx(200.0, rel=1e-4)
    assert p2["w"] is w and not torch.equal(w, torch.ones(4))
    assert s2 is s and float(s["w"]["m"].abs().max()) > 0


# ---------------------------------------------------------------------------
# loss_fn: remat, CE chunks, trainable parameters (the gradients against
# jax.grad are in test_torch_train_grads.py)
# ---------------------------------------------------------------------------
def _batch(cfg, B, T, seed):
    """As the reference's tests/test_models.py trains each arch, with a
    few masked labels."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "none":
        out["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    else:
        out["embeds"] = rng.normal(0, 1, (B, T, cfg.frontend_dim)).astype(
            np.float32)
        if cfg.rope_kind == "mrope":
            out["positions"] = np.broadcast_to(
                np.arange(T)[None, :, None], (B, T, 3)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[0, -3:] = -1
    out["labels"] = labels
    return out


def _cfgs(arch, dt, **changes):
    return (dataclasses.replace(get_config(arch, True), dtype=dt, **changes),
            dataclasses.replace(ref_get_config(arch, True), dtype=dt,
                                **changes))


def _ref_params(model):
    """The port model's weights as the reference's tree (bf16 by bits)."""
    def conv(a):
        return jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                           else a)
    return jax.tree.map(conv, params_to_numpy(model))


def test_remat_and_ce_chunks_change_no_number():
    """Checkpointed layers and CE chunks recompute the same sums: the loss
    and gradients equal the plain forward's bit for bit; and the chunked
    CE equals an unchunked CE over forward_train's logits."""
    cfg, _ = _cfgs("gemma2-9b", "float32")
    batch = {k: torch.as_tensor(v) for k, v in
             _batch(cfg, 2, 32, seed=5).items()}
    out = []
    for remat, chunks in ((False, 1), (True, 8), (False, 8)):
        c = dataclasses.replace(cfg, remat=remat)
        model = M.init_params(c, seed=2, device="cpu").requires_grad_()
        loss, (ce, _) = M.loss_fn(c, model, batch, ce_chunks=chunks)
        out.append((loss, ce, torch.autograd.grad(loss, list(
            model.parameters()))))
    (l0, ce0, g0), (l1, ce1, g1), (l2, ce2, g2) = out
    assert torch.equal(l1, l2) and all(map(torch.equal, g1, g2))
    assert abs((l0 - l1).item()) <= 1e-6 * abs(l0.item())
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    with torch.no_grad():
        logits, _ = M.forward_train(cfg, model, batch)
        lab = batch["labels"].long()
        valid = lab >= 0
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, lab.clamp(min=0)[..., None])[..., 0]
        want = float((nll * valid).sum() / valid.sum())
    assert abs(ce2.item() - want) <= 1e-6 * want


def test_trainable_params_and_serving_stay_apart():
    cfg = get_config("granite-3-8b", smoke=True)
    assert not any(p.requires_grad for p in
                   M.init_params(cfg, device="cpu").parameters())
    model = M.init_params(cfg, device="cpu").requires_grad_()
    assert all(p.requires_grad for p in model.parameters())
    tree = model.tree()
    assert sorted(tree) == ["blocks", "embed", "final_norm"]
    assert tree["blocks"][0]["wq"] is model.blocks[0]["wq"]
    step = make_train_step(cfg, O.OptConfig(), device="cpu")
    frozen = M.init_params(cfg, device="cpu")
    batch = P.SyntheticLM(cfg, 2, 8).batch_at(0)
    with pytest.raises(ValueError, match=r"requires_grad_\(\)"):
        step(frozen, O.init_opt_state(frozen, O.OptConfig()), batch, 0)


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------
# granite-3-8b's smoke config with bf16 masters and 8-bit moments: the
# bf16 accumulation and the codec inside the step, at granite's cost
BF16_8BIT = dict(param_dtype="bfloat16", opt_8bit=True)
STEP_CASES = [(1, None, {}), (2, None, {}), (1, "rubato-128l", {}),
              (2, "rubato-128l", {}), (2, None, BF16_8BIT)]


@pytest.mark.parametrize("microbatch,cipher,changes", STEP_CASES,
                         ids=["m1", "m2", "m1-rubato", "m2-rubato",
                              "m2-bf16-8bit"])
def test_train_step_matches_the_reference(microbatch, cipher, changes):
    """Three steps of granite-3-8b's smoke config from the same weights on
    the same batches, float32 compute."""
    cfg, rcfg = _cfgs("granite-3-8b", "float32", **changes)
    B, T = 4, 16
    kw = dict(lr=1e-2, eightbit=cfg.opt_8bit, total_steps=3, warmup_steps=1)
    opt, ropt = O.OptConfig(**kw), RO.OptConfig(**kw)
    src = P.SyntheticLM(cfg, B, T, seed=5)
    rsrc = RP.SyntheticLM(rcfg, B, T, seed=5)
    dec = rdec = None
    if cipher:
        ci = make_cipher(cipher, seed=6, device="cpu")
        rci = ref_make_cipher(cipher, seed=6)
        src, rsrc = E.EncryptedSource(src, ci), RE.EncryptedSource(rsrc, rci)
        dec, rdec = E.make_decryptor(ci), RE.make_decryptor(rci)
    rstep, _ = ref_train_step(
        rcfg, make_policy(make_host_mesh(), rcfg, batch=B, train=True), ropt,
        microbatch=microbatch, decryptor=rdec, donate=False)
    step = make_train_step(cfg, opt, microbatch=microbatch, decryptor=dec,
                           device="cpu")
    model = M.init_params(cfg, seed=8, device="cpu").requires_grad_()
    rparams = _ref_params(model)
    state, rstate = O.init_opt_state(model, opt), RO.init_opt_state(
        rparams, ropt)
    for i in range(3):
        times = {}
        model, state, m = step(model, state, src.batch_at(i), i, times=times)
        rparams, rstate, rm = rstep(rparams, rstate,
                                    jax.tree.map(jnp.asarray,
                                                 rsrc.batch_at(i)),
                                    jnp.asarray(i, jnp.int32))
        for k in ("loss", "grad_norm"):
            assert _rel(m[k], rm[k]) <= 1e-4, (i, k)
        assert abs(m["lr"] - float(rm["lr"])) <= 1e-4 * float(rm["lr"])
        assert set(times) == {"decrypt_ms", "fwd_bwd_ms", "adamw_ms",
                              "step_ms"}
        toks = step.last_batch["tokens"]
        assert toks.dtype == torch.int32
        plain = (src.source if cipher else src).batch_at(i)["tokens"]
        np.testing.assert_array_equal(toks.numpy(), plain)
    if changes:
        assert model.embed.dtype == torch.bfloat16
        assert state["embed"]["m_q"].dtype == torch.int8


def test_microbatches_interleave_rows_as_the_reference_splits():
    from repro_torch.train.train_loop import _interleaved

    x = torch.arange(12).reshape(6, 2)
    parts = _interleaved(x, 3)
    assert parts.shape == (3, 2, 2)
    for i in range(3):
        assert torch.equal(parts[i], x[i::3])


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
def _bf16_states():
    """Weights and an 8-bit state after one reference step: bf16 masters,
    int8 moments, float32 scales and moments."""
    cfg, _ = _cfgs("granite-3-8b", "float32", **BF16_8BIT)
    ropt = RO.OptConfig(eightbit=True, warmup_steps=1)
    rparams = _ref_params(M.init_params(cfg, seed=1, device="cpu"))
    rstate = RO.init_opt_state(rparams, ropt)
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), rparams)
    rparams, rstate, _ = jax.jit(RO.adamw_update, static_argnums=4)(
        rparams, g, rstate, jnp.asarray(0, jnp.int32), ropt)
    return cfg, rparams, rstate


def _port_like(cfg):
    model = M.init_params(cfg, seed=99, device="cpu").requires_grad_()
    return model, O.init_opt_state(model, O.OptConfig(eightbit=True))


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    cfg, rparams, rstate = _bf16_states()
    RCK.save(str(tmp_path), 3, (rparams, rstate), extra={"data_step": 3})
    like = _port_like(cfg)
    out, step, extra = CK.restore(str(tmp_path), like)
    assert out is like and step == 3 and extra == {"data_step": 3}
    want = _ref_named((rparams, rstate))
    got = _port_named(like)
    assert sorted(got) == sorted(want)
    dtypes = set()
    for name, w in want.items():
        dtypes.add(str(got[name].dtype))
        np.testing.assert_array_equal(_bits(got[name]), _bits(w),
                                      err_msg=name)
    assert {"torch.bfloat16", "torch.int8", "torch.float32"} <= dtypes


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg, rparams, rstate = _bf16_states()
    model, state = _port_like(cfg)
    step = make_train_step(cfg, O.OptConfig(eightbit=True, warmup_steps=1),
                           device="cpu")
    model, state, _ = step(model, state,
                           P.SyntheticLM(cfg, 2, 16).batch_at(0), 0)
    CK.save(str(tmp_path), 7, (model, state), extra={"data_step": 7})
    rlike = jax.eval_shape(lambda: (rparams, rstate))
    rout, rstep, extra = RCK.restore(str(tmp_path), rlike)
    assert rstep == 7 and extra == {"data_step": 7}
    got = _ref_named(rout)
    want = _port_named((model, state))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert str(got[name].dtype) == str(w.dtype).split(".")[1], name
        np.testing.assert_array_equal(_bits(got[name]), _bits(w),
                                      err_msg=name)


def test_checkpoint_gc_latest_async_and_mismatch(tmp_path):
    tree = {"a": torch.randn(8, 4),
            "b": [torch.arange(5, dtype=torch.int32),
                  {"c": torch.randn(3).to(torch.bfloat16)}]}
    d = str(tmp_path / "ck")
    assert CK.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        CK.restore(d, tree)
    for step in (10, 20, 30, 40):
        CK.save(d, step, tree, extra={"data_step": step}, keep_last=2)
    assert CK.latest_step(d) == 40
    assert sorted(os.listdir(d)) == ["step_0000000030", "step_0000000040"]
    like = {"a": torch.zeros(8, 4),
            "b": [torch.zeros(5, dtype=torch.int32),
                  {"c": torch.zeros(3, dtype=torch.bfloat16)}]}
    out, step, extra = CK.restore(d, like, step=30)
    assert step == 30 and extra["data_step"] == 30
    for (_, a), (_, b) in zip(leaves_with_paths(tree),
                              leaves_with_paths(out)):
        assert torch.equal(a, b)
    # the same names and dtypes as the reference's manifest
    jtree = {"a": jnp.zeros((8, 4)), "b": [jnp.zeros(5, jnp.int32),
                                           {"c": jnp.zeros(3, jnp.bfloat16)}]}
    RCK.save(str(tmp_path / "ref"), 1, jtree)
    import json
    man = [json.load(open(os.path.join(p, "manifest.json")))["leaves"]
           for p in (os.path.join(d, "step_0000000040"),
                     str(tmp_path / "ref" / "step_0000000001"))]
    assert [(m["name"], m["dtype"], m["shape"]) for m in man[0]] == \
        [(m["name"], m["dtype"], m["shape"]) for m in man[1]]
    # async: the host copy is taken before save returns
    saved = tree["a"].clone()
    t = CK.save(d, 50, tree, async_write=True)
    tree["a"].add_(1.0)
    t.join(timeout=60)
    assert not t.is_alive() and CK.latest_step(d) == 50
    out, _, _ = CK.restore(d, like)
    assert torch.equal(out["a"], saved)
    # a shape or dtype mismatch writes nothing
    bad = {"a": torch.zeros(5, 4), "b": like["b"]}
    with pytest.raises(ValueError, match="shape mismatch for a"):
        CK.restore(d, bad)
    assert not bad["a"].any()
    with pytest.raises(ValueError, match="dtype mismatch for a"):
        CK.restore(d, {"a": torch.zeros(8, 4, dtype=torch.float64),
                       "b": like["b"]})


# ---------------------------------------------------------------------------
# elastic planning and the watchdog
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,model,multi_pod", [
    (256, 16, False), (250, 16, False), (512, 16, True), (31, 4, False),
    (8, 16, False), (100, 8, True)])
def test_plan_mesh_matches_the_reference(n, model, multi_pod):
    try:
        want = REL.plan_mesh(n, model=model, multi_pod=multi_pod)
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match=str(e)):
            EL.plan_mesh(n, model=model, multi_pod=multi_pod)
        return
    got = EL.plan_mesh(n, model=model, multi_pod=multi_pod)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("kw,series", [
    (dict(patience=3, warmup=2), [1.0] * 20 + [5.0] * 10),
    (dict(patience=3, warmup=2), [5.0 if s == 15 else 1.0
                                  for s in range(30)]),
    (dict(), list(np.random.default_rng(4).uniform(0.5, 3.0, 60))),
])
def test_straggler_watchdog_matches_the_reference(kw, series):
    w, rw = EL.StragglerWatchdog(**kw), REL.StragglerWatchdog(**kw)
    fired = [w.observe(s, t) for s, t in enumerate(series)]
    assert fired == [rw.observe(s, t) for s, t in enumerate(series)]
    assert w.events == rw.events and w._ema == rw._ema


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------
def test_launch_train_cli_then_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-3-8b", "--smoke", "--steps", "3", "--encrypted",
         "--device", "cpu", "--ckpt-dir", ck, "--log-every", "1"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert [ln.split()[:2] for ln in lines[:3]] == [
        ["step", "0"], ["step", "1"], ["step", "2"]]
    assert lines[-1] == "done" and "jax" not in out.stderr
    assert CK.latest_step(ck) == 3
    r = LT.main(["--arch", "granite-3-8b", "--smoke", "--steps", "5",
                 "--encrypted", "--device", "cpu", "--ckpt-dir", ck])
    printed = capsys.readouterr().out
    assert "resumed from step 3" in printed and printed.endswith("done\n")
    assert r["start_step"] == 3 and [h["step"] for h in r["history"]] == [3, 4]
    assert all(np.isfinite(h["loss"]) for h in r["history"])
    assert CK.latest_step(ck) == 5 and r["device"] == "cpu"


def test_launch_train_observes_the_decrypted_batches():
    cfg = get_config("mamba2-2.7b", smoke=True)
    args = LT.parse_args(["--arch", "x", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--encrypted", "--cipher",
                          "hera-128a", "--device", "cpu", "--seed", "3"])
    seen = []
    r = LT.run(cfg, args,
               observe=lambda s, p, b, m: seen.append((s, p, b, m)))
    src = P.SyntheticLM(cfg, 2, 16, seed=3)
    assert [s for s, *_ in seen] == [0, 1]
    assert all(p is r["params"] for _, p, _, _ in seen)
    for step, _, batch, _ in seen:
        toks = src.batch_at(step)["tokens"]
        np.testing.assert_array_equal(batch["tokens"].numpy(), toks)
        np.testing.assert_array_equal(batch["labels"][:, :-1].numpy(),
                                      toks[:, 1:])
        assert (batch["labels"][:, -1] == -1).all()
    assert len(r["history"]) == 2


def test_example_trains_on_encrypted_data_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_encrypted_training.py"),
         "--device", "cpu", "--steps", "40", "--layers", "2", "--d-model",
         "64", "--batch", "4", "--seq", "32", "--vocab", "256"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "DECREASED" in out.stdout and "jax" not in out.stderr
