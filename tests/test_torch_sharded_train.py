"""The port's sharded training (``launch.train.run`` on a mesh: the train
step over DTensor parameters and 8-bit moments, ``checkpoint`` save and
``restore(shardings=)``, ``compressed_pod_reduce``) on a gloo world of
4 CPU ranks (``tests/test_torch_world.py``), and what needs no world.

granite-3-8b at smoke width, float32 compute and masters, 8-bit
moments, trained 2 steps on rubato-128l-encrypted batches with
microbatch 2, once on one device and once on a (2, 2) mesh with FSDP
forced on (``hbm_bytes=1``).  Tolerances:

* the sharded step against the one-device step: loss and grad_norm
  within 1e-4 relative and lr exact at each step; the 8-bit moment
  codes within one code (a float32 value a few ulps off can round to the
  next code) and their row scales within 1e-4 relative; every parameter
  and float32 moment within 1e-4 of its leaf's largest magnitude (a code
  one off moves that step's update of the element by up to 1/127 of it);
* the checkpoint saved at (2, 2), restored at (1, 4) with ``shardings=``
  and by the reference's ``restore``: exact, leaf for leaf;
* ``compressed_pod_reduce`` at pod 2 against its numpy formula: exact
  (the same float32 operations), and at pod 1 against the reference's:
  exact;
* ``launch.train --production-mesh`` in a world of one raises and names
  the 256 ranks it needs.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import checkpoint as RCK  # noqa: E402
from repro.train import compression as RC  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402

from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.train.compression import (  # noqa: E402
    compressed_pod_reduce,
    init_error_buffers,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_world import run_world  # noqa: E402

ARCH, STEPS, BATCH, SEQ = "granite-3-8b", 2, 4, 16
POD_SHAPES = {"w": (2, 6, 8), "b": (2, 40)}


def _q8(x):
    """The reference's quantizer in numpy float32."""
    amax = np.abs(x).max(-1, keepdims=True)
    scale = np.where(amax > 0, amax / np.float32(127.0),
                     np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(7)
    pod_g = {k: rng.normal(0, 1, s).astype(np.float32)
             for k, s in POD_SHAPES.items()}
    pod_e = {k: rng.normal(0, 1e-2, s).astype(np.float32)
             for k, s in POD_SHAPES.items()}
    work = tmp_path_factory.mktemp("world_train")
    inp = {"arch": ARCH, "steps": STEPS, "batch": BATCH, "seq": SEQ,
           "ckpt_dir": str(work / "ckpt"), "pod_grads": pod_g,
           "pod_err": pod_e}
    return run_world("train", 4, work / "run", inp, timeout=280), inp


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def test_sharded_step_matches_the_one_device_step(world):
    res, _ = world
    assert res["policy"] == (True, 2, 2)       # FSDP on, dp 2, model 2
    one, shd = res["history"]
    assert len(one) == len(shd) == STEPS
    for (l1, g1, lr1), (l2, g2, lr2) in zip(one, shd):
        assert _rel(l2, l1) <= 1e-4 and _rel(g2, g1) <= 1e-4
        assert lr1 == lr2


def test_sharded_step_updates_every_parameter_as_one_device(world):
    p1, p2 = world[0]["params"]
    assert sorted(p1) == sorted(p2)
    for name, want in p1.items():
        err = np.abs(p2[name] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), name


def test_sharded_step_moments_match_one_device(world):
    o1, o2 = world[0]["opt"]
    assert sorted(o1) == sorted(o2)
    assert any(k.endswith("_m_q") for k in o1)          # 8-bit moments
    for name, want in o1.items():
        got = o2[name]
        if name.endswith(("_m_q", "_v_q")):
            assert np.abs(got - want).max() <= 1, name
        elif name.endswith(("_m_s", "_v_s")):
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        else:
            assert np.abs(got - want).max() <= 1e-4 * max(
                np.abs(want).max(), 1e-30), name


def test_checkpoint_saved_at_2x2_restores_at_1x4(world):
    res, _ = world
    assert res["restored_step"] == STEPS
    saved = {}
    for k, v in res["params"][1].items():
        saved[f"0_{k}"] = v
    for k, v in res["opt"][1].items():
        saved[f"1_{k}"] = v
    assert sorted(res["restored"]) == sorted(saved)
    for name, want in saved.items():
        np.testing.assert_array_equal(res["restored"][name], want, name)
    # laid out over the (1, 4) mesh's two tp axes, not (2, 2)'s
    assert any("Shard" in lay for lay in res["restored_layouts"])


def test_checkpoint_saved_sharded_restores_in_the_reference(world):
    res, inp = world
    rcfg = dataclasses.replace(ref_get_config(ARCH, smoke=True),
                               dtype="float32", param_dtype="float32",
                               opt_8bit=True)
    params = RM.init_params(rcfg, jax.random.key(1))
    opt = RO.init_opt_state(params, RO.OptConfig(eightbit=True))
    (rp, ro), step, extra = RCK.restore(inp["ckpt_dir"], (params, opt))
    assert step == STEPS and extra == {"data_step": STEPS}
    got = {}
    for tree in (rp, ro):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            got["_".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path)] = np.asarray(leaf)
    for name, want in res["params"][1].items():
        np.testing.assert_array_equal(got[name], want, name)
    for name, want in res["opt"][1].items():
        np.testing.assert_array_equal(
            np.asarray(got[name], dtype=want.dtype), want, name)


def test_compressed_pod_reduce_at_pod2_is_the_formula(world):
    res, inp = world
    assert res["pod_mesh"][0] == "pod"
    pod = res["pod"]
    for k in POD_SHAPES:
        xs = [inp["pod_grads"][k][p] + inp["pod_err"][k][p] for p in (0, 1)]
        qs = [_q8(x) for x in xs]
        qsum = (qs[0][0].astype(np.int32) + qs[1][0].astype(np.int32))
        ssum = qs[0][1] + qs[1][1]
        ghat = qsum.astype(np.float32) * (ssum / np.float32(2)) / np.float32(2)
        np.testing.assert_array_equal(pod["ghat"][k], ghat)
        for r, p in enumerate(pod["ranks_pod"]):
            want = xs[p] - qs[p][0].astype(np.float32) * qs[p][1]
            np.testing.assert_array_equal(pod["err"][r][k], want)


def test_compressed_pod_reduce_at_pod1_matches_the_reference():
    rng = np.random.default_rng(8)
    g = {k: rng.normal(0, 1, s[1:]).astype(np.float32)
         for k, s in POD_SHAPES.items()}
    e = {k: rng.normal(0, 1e-2, s[1:]).astype(np.float32)
         for k, s in POD_SHAPES.items()}
    mesh = jax.make_mesh((1,), ("pod",))
    rg, re_ = RC.compressed_pod_reduce(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in e.items()}, mesh)
    pg, pe = compressed_pod_reduce(
        {k: torch.as_tensor(v) for k, v in g.items()},
        {k: torch.as_tensor(v) for k, v in e.items()}, None)
    for k in POD_SHAPES:
        np.testing.assert_array_equal(pg[k].numpy(), np.asarray(rg[k]))
        np.testing.assert_array_equal(pe[k].numpy(), np.asarray(re_[k]))
    zeros = init_error_buffers({k: torch.as_tensor(v) for k, v in g.items()})
    assert all(z.dtype == torch.float32 and not z.any()
               for z in zeros.values())


def test_launch_train_production_mesh_names_the_world_it_needs():
    with pytest.raises(RuntimeError, match="world of 256 ranks"):
        LT.main(["--arch", ARCH, "--smoke", "--steps", "1", "--device",
                 "cpu", "--production-mesh"])
