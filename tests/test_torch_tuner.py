"""The port's StreamPlan tuner and its ``plan=`` path against the JAX
package's: the plan's JSON form, the candidate grid, the cache (persist,
reload, nearest lanes, stale schema, invalid backends, host and device
scoping), "auto" resolution through the cache under the device rule, and
the farm and server serving from a plan word for word as the JAX ones
do.  Every cache lives under ``tmp_path``; no test touches the default."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.cipher import CipherBatch as RefBatch  # noqa: E402
from repro.core.farm import KeystreamFarm as RefFarm  # noqa: E402
from repro.core.producer import resolve_producer as ref_resolve_producer  # noqa: E402
from repro.core import tuner as RT  # noqa: E402
from repro.serve.hhe_loop import HHERequest as RefRequest  # noqa: E402
from repro.serve.hhe_loop import HHEServer as RefServer  # noqa: E402

from repro_torch.core import tuner as T  # noqa: E402
from repro_torch.core.cipher import CipherBatch  # noqa: E402
from repro_torch.core.convert import batch_from_reference  # noqa: E402
from repro_torch.core.engine import resolve_engine  # noqa: E402
from repro_torch.core.farm import KeystreamFarm  # noqa: E402
from repro_torch.core.params import get_params  # noqa: E402
from repro_torch.core.producer import make_producer, resolve_producer  # noqa: E402
from repro_torch.core.tuner import PLAN_SCHEMA, StreamPlan  # noqa: E402
from repro_torch.serve.hhe_loop import HHERequest, HHEServer  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(sessions=2, n_windows=2, reps=1)


@pytest.fixture(autouse=True)
def isolated_caches(tmp_path, monkeypatch):
    """Both tuners' default caches point into this test's directory."""
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_TUNER_CACHE", str(tmp_path / "jax.json"))


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA device as far as names go (no kernel runs): fingerprints and
    caps of a card, so host scoping and the device rule are testable on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    return torch.device("cuda", 0)


def _tiny_autotune(cache, **kw):
    args = dict(engines=["ref"], variants=["normal"], windows=[8],
                depths=[2], producers=["aes"], reductions=["lazy"],
                cache_path=cache, device=CPU, **TINY)
    args.update(kw)
    return T.autotune("rubato-128s", 8, **args)


def _as_ref(plan):
    """The same plan on the JAX side: its ``jax`` engine for ``ref``."""
    return RT.StreamPlan.from_json(dict(
        plan.to_json(), engine="jax" if plan.engine == "ref" else plan.engine))


# ---------------------------------------------------------------------------
# StreamPlan and the grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plan", [
    StreamPlan("cached", "ref", "alternating", 128, 3),
    StreamPlan("aes", "cuda", "normal", 4096, 2, 2, "eager"),
])
def test_stream_plan_json_matches_reference(plan):
    d = plan.to_json()
    ref = RT.StreamPlan.from_json(d)
    assert ref.to_json() == d and StreamPlan.from_json(ref.to_json()) == plan
    assert plan.describe() == ref.describe()
    d2 = json.loads(json.dumps(dict(d, p50_ms=1.23, measured_at=0.0)))
    assert StreamPlan.from_json(d2) == plan
    legacy = {k: v for k, v in d.items()
              if k not in ("matrix_depth", "reduction")}
    assert StreamPlan.from_json(legacy).to_json() == \
        RT.StreamPlan.from_json(legacy).to_json()
    assert StreamPlan.from_json(legacy) == StreamPlan(
        *[d[k] for k in ("producer", "engine", "variant", "window", "depth")])
    assert T.PLAN_SCHEMA == RT.PLAN_SCHEMA and T.CACHE_VERSION == \
        RT.CACHE_VERSION


@pytest.mark.parametrize("name,lanes", [("hera-128a", 16),
                                        ("rubato-128s", 8),
                                        ("pasta-128s", 8)])
def test_candidate_grid_matches_reference(name, lanes):
    """The CPU grid is the reference's, with ``ref`` where it has ``jax``
    (the engine that runs on the device other than the oracle)."""
    got = [p.to_json() for p in T.candidate_plans(name, lanes, device=CPU)]
    want = [dict(p.to_json(), engine="ref")
            for p in RT.candidate_plans(name, lanes)]
    assert {p.engine for p in RT.candidate_plans(name, lanes)} == {"jax"}
    assert got == want and len(got) in (32, 64)
    assert "threefry" not in {p["producer"] for p in got}


def test_candidate_engines_follow_the_device(fake_card):
    assert {p.engine for p in T.candidate_plans("hera-128a", 8,
                                                device=fake_card)} == {"cuda"}
    assert {p.engine for p in T.candidate_plans("hera-128a", 8,
                                                device=CPU)} == {"ref"}


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------
def test_autotune_persists_and_reloads_deterministically(tmp_path,
                                                         monkeypatch):
    cache = tmp_path / "plans.json"
    plan = _tiny_autotune(cache, depths=[2, 3])
    entry = json.loads(cache.read_text())["plans"][
        T.cache_key(get_params("rubato-128s"), 8, CPU)]
    assert StreamPlan.from_json(entry) == plan
    assert entry["schema"] == PLAN_SCHEMA and entry["backend"] == "cpu"
    assert [m["depth"] for m in entry["measurements"]] == [2, 3]

    def no_timing(*a, **k):
        raise AssertionError("a cache hit must not re-time")

    monkeypatch.setattr(T, "measure_plan", no_timing)
    for _ in range(2):
        assert _tiny_autotune(cache, depths=[2, 3]) == plan
    assert T.load_plan("rubato-128s", 8, cache, device=CPU) == plan


def test_cache_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNER_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path))
    path = T.default_cache_path()
    assert path.name == "streamplans-torch.json"
    assert path != RT.default_cache_path()
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", str(tmp_path / "x.json"))
    assert T.default_cache_path() == tmp_path / "x.json"


def test_load_plan_nearest_lanes_fallback(tmp_path):
    cache = tmp_path / "plans.json"
    p8 = StreamPlan("aes", "ref", "normal", 8, 2)
    p64 = StreamPlan("cached", "ref", "normal", 64, 3)
    for lanes, plan in ((8, p8), (64, p64)):
        T.save_plan("rubato-128s", lanes, plan, 1.0, cache, device=CPU)
        RT.save_plan("rubato-128s", lanes, _as_ref(plan), 1.0,
                     tmp_path / "ref.json")
    for lanes, want in ((8, p8), (48, p64), (None, p64), (30, p8),
                        (36, p8)):
        assert T.load_plan("rubato-128s", lanes, cache, device=CPU) == want
        assert RT.load_plan("rubato-128s", lanes, tmp_path / "ref.json") \
            == _as_ref(want)
    assert T.load_plan("hera-128a", 8, cache, device=CPU) is None


@pytest.mark.parametrize("plan,why", [
    (StreamPlan("threefry", "ref", "normal", 8, 2), "wrong stream"),
    (StreamPlan("aes", "vulkan", "normal", 8, 2), "unknown engine"),
    (StreamPlan("aes", "ref", "diagonal", 8, 2), "unknown variant"),
    (StreamPlan("aes", "ref", "normal", 8, 2, 1, "sloppy"), "unknown mode"),
    (StreamPlan("aes", "cuda", "normal", 8, 2), "engine not on the CPU"),
    (StreamPlan("chacha", "ref", "normal", 8, 2), "unknown producer"),
])
def test_load_plan_rejects_invalid_backends(tmp_path, plan, why):
    cache = tmp_path / "plans.json"
    T.save_plan("hera-128a", 8, plan, 1.0, cache, device=CPU)
    assert T.load_plan("hera-128a", 8, cache, device=CPU) is None, why
    assert T.load_plan("hera-128a", None, cache, device=CPU) is None, why


def _rewrite_entry_schema(cache, schema):
    data = json.loads(cache.read_text())
    for entry in data["plans"].values():
        if schema is None:
            entry.pop("schema", None)
        else:
            entry["schema"] = schema
    cache.write_text(json.dumps(data))


@pytest.mark.parametrize("stale", [None, PLAN_SCHEMA - 1, PLAN_SCHEMA + 1,
                                   "garbage"])
def test_load_plan_ignores_stale_schema_entries(tmp_path, stale):
    cache = tmp_path / "plans.json"
    plan = StreamPlan("aes", "ref", "normal", 8, 2)
    T.save_plan("rubato-128s", 8, plan, 1.0, cache,
                measurements=[dict(plan.to_json(), p50_ms=1.0)], device=CPU)
    assert T.load_plan("rubato-128s", 8, cache, device=CPU) == plan
    assert len(T.load_measurements("rubato-128s", 8, cache, device=CPU)) == 1
    _rewrite_entry_schema(cache, stale)
    assert T.load_plan("rubato-128s", 8, cache, device=CPU) is None
    assert T.load_measurements("rubato-128s", 8, cache, device=CPU) == []
    # a stale hit is no hit: autotune measures and restamps
    again = _tiny_autotune(cache)
    entry = json.loads(cache.read_text())["plans"][
        T.cache_key(get_params("rubato-128s"), 8, CPU)]
    assert entry["schema"] == PLAN_SCHEMA and StreamPlan.from_json(entry) \
        == again


def test_nearest_lanes_fallback_skips_stale_schema(tmp_path):
    cache = tmp_path / "plans.json"
    T.save_plan("rubato-128s", 8, StreamPlan("aes", "ref", "normal", 8, 2),
                1.0, cache, device=CPU)
    _rewrite_entry_schema(cache, PLAN_SCHEMA - 1)
    p64 = StreamPlan("cached", "ref", "normal", 64, 3)
    T.save_plan("rubato-128s", 64, p64, 1.0, cache, device=CPU)
    assert T.load_plan("rubato-128s", 16, cache, device=CPU) == p64


@pytest.mark.parametrize("garbage", ["", "[]", '{"version": 1}',
                                     '{"version": 1, "plans": []}',
                                     '{"version": 2, "plans": {}}'])
def test_unreadable_cache_is_empty(tmp_path, garbage):
    cache = tmp_path / "plans.json"
    cache.write_text(garbage)
    assert T.load_plan("hera-128a", None, cache, device=CPU) is None
    assert T.load_measurements("hera-128a", None, cache, device=CPU) == []


def test_cache_key_is_host_and_device_scoped(tmp_path, fake_card):
    p = get_params("rubato-128l")
    k = T.cache_key(p, 32, CPU)
    assert k.startswith("rubato-128l|lanes=32|noise=60|host=")
    assert k.split("|host=")[0] == RT.cache_key(p, 32).split("|host=")[0]
    assert T.host_fingerprint(CPU) != T.host_fingerprint(fake_card)
    cache = tmp_path / "plans.json"
    cpu_plan = StreamPlan("cached", "ref", "normal", 8, 2)
    T.save_plan(p, 8, cpu_plan, 1.0, cache, device=CPU)
    assert T.load_plan(p, 8, cache, device=CPU) == cpu_plan
    assert T.load_plan(p, 8, cache, device=fake_card) is None
    assert T.load_plan(p, None, cache, device=fake_card) is None
    card_plan = StreamPlan("aes", "cuda", "alternating", 8, 3)
    T.save_plan(p, 16, card_plan, 1.0, cache, device=fake_card)
    assert T.load_plan(p, None, cache, device=fake_card) == card_plan
    assert T.load_plan(p, None, cache, device=CPU) == cpu_plan


# ---------------------------------------------------------------------------
# "auto" through the cache, under the device rule
# ---------------------------------------------------------------------------
def test_auto_resolution_consults_persisted_plan(tmp_path):
    p = get_params("rubato-128s")
    assert resolve_engine("auto", CPU, p) == "ref"
    assert resolve_producer("auto", p, CPU) == p.xof
    assert ref_resolve_producer("auto", RT.get_params("rubato-128s")) == p.xof
    plan = StreamPlan("cached", "ref", "normal", 8, 2)
    T.save_plan(p, 8, plan, 1.0, device=CPU)
    RT.save_plan("rubato-128s", 8, _as_ref(plan), 1.0)
    assert resolve_producer("auto", p, CPU) == "cached" == \
        ref_resolve_producer("auto", RT.get_params("rubato-128s"))
    assert resolve_engine("auto", CPU, p) == "ref"
    assert make_producer("auto", p, device=CPU).name == "cached"
    assert make_producer(None, p, device=CPU).name == p.xof   # None: static
    cb = CipherBatch(p, seed=1, producer="auto", device=CPU)
    assert cb.producer.name == "cached"
    # no device context: a bare name lookup has no plan to consult
    assert resolve_producer("auto", p) == p.xof


def test_auto_never_crosses_the_device_rule(tmp_path, fake_card):
    p = get_params("hera-128a")
    # a card-scoped plan naming the oracle: the card keeps its kernel
    T.save_plan(p, 256, StreamPlan("cached", "ref", "normal", 256, 2), 1.0,
                device=fake_card)
    assert T.load_plan(p, None, device=fake_card).engine == "ref"
    assert resolve_engine("auto", fake_card, p) == "cuda"
    assert resolve_producer("auto", p, fake_card) == "cached"
    # a CPU-scoped plan naming the kernel engine is invalid on the CPU
    T.save_plan(p, 256, StreamPlan("cached", "cuda", "normal", 256, 2), 1.0,
                device=CPU)
    assert T.load_plan(p, None, device=CPU) is None
    assert resolve_engine("auto", CPU, p) == "ref"
    assert resolve_producer("auto", p, CPU) == p.xof


@pytest.mark.parametrize("on_card", [False, True])
def test_auto_engine_reads_no_cache_no_plan_could_change(on_card, request,
                                                         monkeypatch):
    """With the registered engines, the device rule alone decides: "auto"
    leaves the cache unread (every farm and auto cipher resolves it)."""
    dev = request.getfixturevalue("fake_card") if on_card else CPU
    p = get_params("hera-128a")
    T.save_plan(p, 256, StreamPlan("aes", "ref", "normal", 256, 2), 1.0,
                device=dev)

    def unread(*args, **kwargs):
        raise AssertionError("the tuner's cache was read")

    monkeypatch.setattr(T, "load_plan", unread)
    assert resolve_engine("auto", dev, p) == ("cuda" if on_card else "ref")


def test_auto_engine_follows_plan_among_rival_engines(monkeypatch):
    """Once a second engine could serve the device, the cached plan's
    engine decides "auto", and without a plan the device rule does."""
    from repro_torch.core import engine as E

    class RivalEngine(E.RefEngine):
        name = "rival"

        @classmethod
        def query_caps(cls):
            return E.EngineCaps(name=cls.name, description="a second "
                                "CPU engine", available=True,
                                device_types=("cpu",))

    monkeypatch.setitem(E._REGISTRY, "rival", RivalEngine)
    p = get_params("hera-128a")
    assert resolve_engine("auto", CPU, p) == "ref"
    T.save_plan(p, 256, StreamPlan("aes", "rival", "normal", 256, 2), 1.0,
                device=CPU)
    assert resolve_engine("auto", CPU, p) == "rival"
    assert resolve_engine("auto", CPU) == "ref"       # no params context


# ---------------------------------------------------------------------------
# plan= on the farm and the server, against the JAX package
# ---------------------------------------------------------------------------
def _pair(name, sessions, seed):
    ref = RefBatch(name, seed=seed, engine="ref")
    ref.add_sessions(sessions)
    port = batch_from_reference(
        name, np.asarray(ref.key), np.stack([s.nonce for s in ref.sessions]),
        device="cpu")
    port._rng.bit_generator.state = ref._rng.bit_generator.state
    return ref, port


@pytest.mark.parametrize("name,plan", [
    ("rubato-128s", StreamPlan("cached", "ref", "alternating", 4, 3)),
    ("rubato-128s", StreamPlan("aes", "ref", "normal", 8, 2, 1, "eager")),
    ("pasta-128s", StreamPlan("aes", "ref", "normal", 4, 2, 2)),
])
def test_farm_applies_plan_like_the_reference(name, plan):
    ref, port = _pair(name, 2, seed=21)
    rf = RefFarm(ref, plan=_as_ref(plan))
    pf = KeystreamFarm(port, plan=plan)
    assert port.producer.name == ref.producer.name == plan.producer
    assert (pf.engine.name, pf.engine.variant, pf.engine.reduction) == \
        ("ref", plan.variant, plan.reduction)
    assert (pf.depth, pf.matrix_depth, pf.window, pf._splits_planes) == \
        (rf.depth, rf.matrix_depth, rf.window, rf._splits_planes)
    assert pf.plan == plan and pf.window == plan.window
    sids = np.array([0, 1, 0, 1, 1, 0, 0, 1, 1])
    ctrs = np.array([0, 0, 1, 1, 2, 2, 3, 3, 4])
    z = pf.keystream(sids, ctrs)                 # windowed by plan.window
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(rf.keystream(sids, ctrs)).astype(np.int64))


def test_farm_explicit_args_override_plan():
    plan = StreamPlan("cached", "ref", "alternating", 4, 3, 2, "eager")
    ref, port = _pair("pasta-128s", 1, seed=22)
    pf = KeystreamFarm(port, engine="ref", variant="normal", depth=2,
                       matrix_depth=1, reduction="lazy", plan=plan)
    rf = RefFarm(ref, engine="ref", variant="normal", depth=2,
                 matrix_depth=1, reduction="lazy", plan=_as_ref(plan))
    assert (pf.engine.variant, pf.depth, pf.matrix_depth,
            pf.engine.reduction) == ("normal", 2, 1, "lazy") == \
        (rf.engine.variant, rf.depth, rf.matrix_depth, rf.engine.reduction)
    assert port.producer.name == "cached" and pf.window == 4


def test_hhe_server_serves_from_plan_like_the_reference():
    plan = StreamPlan("cached", "ref", "alternating", 4, 3)
    ref, port = _pair("rubato-128s", 3, seed=23)
    rs = RefServer(ref, plan=_as_ref(plan))
    ps = HHEServer(port, plan=plan)
    assert ps.window == rs.window == 4 and ps.farm.depth == rs.farm.depth == 3
    assert port.producer.name == "cached"
    assert HHEServer(port, window=8, plan=plan).window == 8
    rng = np.random.default_rng(5)
    l = port.params.l
    reqs = [(0, "keystream", 6, None), (1, "encrypt", 3,
             rng.integers(-512, 512, (3, l)) / 1024.0),
            (2, "keystream", 5, None), (0, "encrypt_tokens", 2,
             rng.integers(0, 1000, (2, l)))]
    for sid, op, blocks, payload in reqs:
        rs.submit(RefRequest(session_id=sid, op=op, payload=payload,
                             blocks=blocks))
        ps.submit(HHERequest(session_id=sid, op=op, payload=payload,
                             blocks=blocks))
    got = sorted(ps.flush(), key=lambda r: r.seq)
    want = sorted(rs.flush(), key=lambda r: r.seq)
    assert len(got) == len(want) == len(reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.block_ctrs, np.asarray(w.block_ctrs))
        np.testing.assert_array_equal(np.asarray(g.result),
                                      np.asarray(w.result))
        assert np.asarray(g.result).dtype == np.asarray(w.result).dtype


# ---------------------------------------------------------------------------
# Measuring
# ---------------------------------------------------------------------------
def test_autotune_two_plan_grid_on_the_cpu(tmp_path):
    cache = tmp_path / "plans.json"
    plan = _tiny_autotune(cache, producers=["aes", "cached"])
    grid = T.candidate_plans("rubato-128s", 8, device=CPU,
                             producers=["aes", "cached"], engines=["ref"],
                             variants=["normal"], windows=[8], depths=[2],
                             reductions=["lazy"])
    assert len(grid) == 2 and plan in grid
    rows = T.load_measurements("rubato-128s", 8, cache, device=CPU)
    assert [StreamPlan.from_json(r) for r in rows] == grid
    assert all(r["p50_ms"] > 0 for r in rows)
    best = min(rows, key=lambda r: r["p50_ms"])
    assert StreamPlan.from_json(best) == plan
    assert T.load_measurements("rubato-128s", None, cache, device=CPU) == rows


def test_measure_plan_runs_the_farm_loop():
    p50 = T.measure_plan("pasta-128s",
                         StreamPlan("cached", "ref", "normal", 4, 2, 2), 4,
                         device=CPU, **TINY)
    assert p50 > 0


def test_cli_prints_the_tables(tmp_path, capsys):
    cache = tmp_path / "plans.json"
    T.save_plan("hera-128a", 8, StreamPlan("aes", "ref", "normal", 8, 2),
                2.5, cache, device=CPU)
    assert T.main(["--cache", str(cache), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "hera-128a|lanes=8|noise=0" in out and "2.500" in out
    assert "=== producer registry ===" in out and "auto resolves to" in out
