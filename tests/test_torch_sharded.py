"""The sharded engine: lanes split over a list of devices (the port's
counterpart of the reference's mesh).  On the CPU a list that names the
CPU k times exercises the pad, the split and the trim; every keystream is
held against the reference's `keystream_ref` or its sharded kernel."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.core.params import get_params as ref_get_params  # noqa: E402
from repro.kernels.keystream.ops import (  # noqa: E402
    keystream_kernel_sharded as ref_sharded,
)
from repro.kernels.keystream.ref import keystream_ref as ref_keystream  # noqa: E402

from repro_torch.core.cipher import CipherBatch  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    engine_caps,
    make_engine,
    resolve_engine,
)
from repro_torch.core.farm import KeystreamFarm, plan_windows  # noqa: E402
from repro_torch.core.params import REGISTRY, get_params  # noqa: E402
from repro_torch.core.tuner import (  # noqa: E402
    StreamPlan,
    autotune,
    candidate_plans,
    load_plan,
    save_plan,
)
from repro_torch.kernels.keystream.ops import (  # noqa: E402
    keystream_kernel_sharded,
)
from repro_torch.serve.hhe_loop import HHERequest, HHEServer  # noqa: E402

PRESETS = sorted(REGISTRY)
COPIES = [1, 2, 3]
LANES = [1, 5, 8]      # 5 pads for 2 and 3 shards; 8 fits 2, pads for 3


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", str(path))
    return path


def _planes(name, lanes, seed):
    """Producer-shaped planes from a seed: rc, noise (signed) and mats."""
    p = get_params(name)
    rng = np.random.default_rng(seed)
    q = p.mod.q
    return (rng.integers(1, q, p.n, dtype=np.uint32),
            rng.integers(0, q, (lanes, p.n_round_constants), dtype=np.uint32),
            rng.integers(-16, 17, (lanes, p.l)).astype(np.int32)
            if p.n_noise else None,
            rng.integers(0, q, (lanes, p.n_matrix_constants),
                         dtype=np.uint32) if p.n_matrix_constants else None)


def _t(x):
    return None if x is None else torch.as_tensor(x.astype(np.int64))


def _want(name, key, rc, noise, mats, variant="normal"):
    return np.asarray(ref_keystream(
        ref_get_params(name), jnp.asarray(key), jnp.asarray(rc),
        None if noise is None else jnp.asarray(noise), variant=variant,
        mats=None if mats is None else jnp.asarray(mats))).astype(np.int64)


@pytest.mark.parametrize("name", ["hera-128a", "rubato-128s", "pasta-128s"])
@pytest.mark.parametrize("k", COPIES)
def test_sharded_kernel_pads_splits_and_trims(name, k):
    for lanes in LANES:
        key, rc, noise, mats = _planes(name, lanes, seed=lanes)
        got = keystream_kernel_sharded(
            get_params(name), _t(key), _t(rc), _t(noise), mats=_t(mats),
            devices=["cpu"] * k)
        assert got.shape == (lanes, get_params(name).l)
        np.testing.assert_array_equal(
            got.numpy(), _want(name, key, rc, noise, mats))


@pytest.mark.parametrize("name", PRESETS)
def test_sharded_engine_matches_reference_on_every_preset(name):
    key, rc, noise, mats = _planes(name, 7, seed=3)
    for variant in ("normal", "alternating"):
        want = _want(name, key, rc, noise, mats, variant)
        for reduction in ("lazy", "eager"):
            eng = make_engine("sharded", get_params(name), key,
                              device="cpu", devices=["cpu"] * 3,
                              variant=variant, reduction=reduction)
            got = eng.keystream_from_constants(_t(rc), _t(noise), _t(mats))
            np.testing.assert_array_equal(got.numpy(), want)


def test_one_wide_mesh_matches_the_reference_sharded_kernel():
    """The reference's keystream_kernel_sharded on a 1-wide mesh (the
    Pallas kernel in interpret mode), 6 lanes of rubato-128s with noise."""
    name = "rubato-128s"
    key, rc, noise, mats = _planes(name, 6, seed=4)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want = ref_sharded(ref_get_params(name), jnp.asarray(key),
                       jnp.asarray(rc), jnp.asarray(noise), mesh=mesh,
                       interpret=True)
    got = keystream_kernel_sharded(get_params(name), _t(key), _t(rc),
                                   _t(noise), devices=["cpu"])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_sharded_engine_needs_devices():
    caps = engine_caps()["sharded"]
    assert not caps.available
    assert caps.reason == "needs devices (pass devices= to make_engine)"
    with_devs = engine_caps(devices=["cpu", "cpu"])["sharded"]
    assert with_devs.available and "2 x cpu" in with_devs.description
    p = get_params("hera-80")
    with pytest.raises(RuntimeError, match="needs devices"):
        make_engine("sharded", p, np.ones(p.n), device="cpu")
    with pytest.raises(ValueError, match="devices\\[0\\]"):
        make_engine("sharded", p, np.ones(p.n), device="cpu",
                    devices=["meta"])
    mixed = engine_caps(devices=["cpu", "meta"])["sharded"]
    assert not mixed.available and "mix" in mixed.reason


def test_kernel_and_auto_resolution():
    # the reference's legacy "kernel" spec: sharded with devices, else
    # the device rule's engine
    assert resolve_engine("kernel", "cpu") == "ref"
    assert resolve_engine("kernel", "cuda") == "cuda"
    assert resolve_engine("kernel", "cpu", devices=["cpu"] * 2) == "sharded"
    assert resolve_engine("kernel", "cuda", devices=["cuda"]) == "sharded"
    # "auto" without a tuned plan: the device rule (sharded on a card
    # with devices named)
    assert resolve_engine("auto", "cpu", devices=["cpu"]) == "ref"
    assert resolve_engine("auto", "cuda", devices=["cuda", "cuda"]) \
        == "sharded"
    assert resolve_engine("auto", "cuda") == "cuda"
    with pytest.raises(ValueError, match="'kernel' alias"):
        resolve_engine("pallas", "cpu")


@pytest.mark.parametrize("name", ["hera-128a", "pasta-128s"])
def test_farm_on_devices_matches_the_ref_farm(name):
    cb = CipherBatch(name, seed=2, device="cpu")
    cb.add_sessions(3)
    ref = KeystreamFarm(cb, engine="ref")
    farm = KeystreamFarm(cb, engine="sharded", devices=["cpu"] * 3,
                         matrix_depth=2)
    assert farm.engine.name == "sharded"
    assert farm.engine.devices == (torch.device("cpu"),) * 3
    plans = plan_windows(cb.sessions, 3, window=7)   # reserves counters
    want = list(ref.run(plans))
    got = list(farm.run(plans))
    assert len(got) == len(want) == 2
    for (_, z1), (_, z2) in zip(got, want):
        assert torch.equal(z1, z2)


def test_server_on_devices_matches_the_ref_server():
    name = "rubato-128s"
    responses = []
    for kw in ({}, {"engine": "sharded", "devices": ["cpu"] * 2}):
        cb = CipherBatch(name, seed=4, device="cpu")
        cb.add_sessions(2)
        srv = HHEServer(cb, window=8, **kw)
        rng = np.random.default_rng(0)
        l = cb.params.l
        for sid, op, blocks in [(0, "encrypt", 5), (1, "keystream", 9),
                                (0, "decrypt", 3)]:
            payload = (rng.integers(-900, 900, (blocks, l)) / 1024.0
                       if op == "encrypt" else
                       rng.integers(0, 2**32, (blocks, l)).astype(np.uint32)
                       if op == "decrypt" else None)
            srv.submit(HHERequest(sid, op=op, payload=payload,
                                  blocks=blocks))
        responses.append(srv.flush())
        assert srv.farm.engine.name == kw.get("engine", "ref")
    for a, b in zip(*responses):
        np.testing.assert_array_equal(a.result, b.result)
        np.testing.assert_array_equal(a.block_ctrs, b.block_ctrs)


def test_tuner_grid_gains_sharded_only_with_devices(cache):
    plain = candidate_plans("hera-128a", 8, device="cpu")
    assert {p.engine for p in plain} == {"ref"}
    sharded = candidate_plans("hera-128a", 8, device="cpu",
                              devices=["cpu"] * 2)
    assert {p.engine for p in sharded} == {"sharded"}


def test_a_cached_sharded_plan_needs_devices(cache):
    plan = StreamPlan("aes", "sharded", "normal", 8, 2)
    save_plan("hera-128a", 8, plan, 1.0, device="cpu")
    assert load_plan("hera-128a", 8, device="cpu") is None
    assert load_plan("hera-128a", 8, device="cpu",
                     devices=["cpu"] * 2) == plan
    # "auto" reads the cache only where another engine could serve: on the
    # CPU with devices the tuned sharded plan wins, without them it cannot
    p = get_params("hera-128a")
    assert resolve_engine("auto", "cpu", p) == "ref"
    assert resolve_engine("auto", "cpu", p, devices=["cpu"] * 2) == "sharded"


def test_autotune_with_devices_measures_the_sharded_engine(cache):
    plan = autotune("hera-80", 8, sessions=2, n_windows=2, reps=1,
                    device="cpu", devices=["cpu"] * 2, variants=["normal"],
                    windows=[8], depths=[2], reductions=["lazy"])
    assert plan.engine == "sharded"
    assert load_plan("hera-80", 8, device="cpu") is None
    assert load_plan("hera-80", 8, device="cpu", devices=["cpu"]) == plan
