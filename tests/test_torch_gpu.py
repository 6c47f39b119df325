"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports only the port (no JAX), so it runs on a machine with a
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test here needs a CUDA device and skips without one; the check is
made inside a fixture, never at import.  Comparisons are exact.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import schedule as S  # noqa: E402
from repro_torch.core.cipher import CipherBatch, make_cipher  # noqa: E402
from repro_torch.core.farm import KeystreamFarm, plan_windows  # noqa: E402
from repro_torch.core.params import REGISTRY, get_params  # noqa: E402
from repro_torch.crypto.aes import aes128_key_expand  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.aes.ops import (  # noqa: E402
    aes_ctr_kernel_apply,
    aes_xof_words,
)
from repro_torch.kernels.aes.ref import aes_ctr_ref, aes_xof_ref  # noqa: E402
from repro_torch.kernels.keystream.ops import (  # noqa: E402
    kernel_operands,
    keystream_kernel_apply,
    launch_keystream,
)
from repro_torch.kernels.keystream.ref import keystream_ref  # noqa: E402
from repro_torch.kernels.mrmc.ops import (  # noqa: E402
    kernel_operands as mrmc_operands,
    launch_mrmc,
    mrmc_kernel_apply,
)
from repro_torch.kernels.mrmc.ref import mrmc_ref  # noqa: E402
from repro_torch.crypto import sampler as SMP  # noqa: E402
from repro_torch.kernels.sampler.ops import (  # noqa: E402
    gauss_kernel_apply,
    uniform_kernel_apply,
)
from repro_torch.serve.hhe_loop import HHERequest, HHEServer  # noqa: E402

PRESETS = sorted(REGISTRY)
# lane counts that cut a lane group or a thread block of the kernels
LANE_COUNTS = (1, 31, 1000, 4096)

# SHA-256 of the little-endian keystream words of make_cipher(name,
# seed=123) over block counters 0..3 — the reference's golden digests.
GOLDEN = {
    ("hera-80", "plain"): "c5a66b2b098fede998837c2f7596f0279d9b44968561a3d90058713c5410e052",
    ("hera-128a", "plain"): "894abb58f75f5306e40200bc670d9e4672dd5e345d1f0ad97545c22f1b1132b2",
    ("rubato-128s", "plain"): "9c46b0244571ba344f043498875dea5576c0a6775e39676294191a7e0adf315f",
    ("rubato-128s", "noise"): "e5d632a451be7b27918ac669ef8bf177fd814b779658d28550e396eedc97ee75",
    ("rubato-128m", "plain"): "28a0da4bdad86ca4d35079d7997441efc183508227ff3be81cd271c950b86d8b",
    ("rubato-128m", "noise"): "37acf76c4ab8438e866e6ee38f69c32170fb09462d6012991e3787953921b9ee",
    ("rubato-128l", "plain"): "286453548ffff0abc2231c2603cd895410bab849f334f58b6eff6276d74a5471",
    ("rubato-128l", "noise"): "f89adf017a718905d2e7c40eaac8aebb014111ecba24975b52b75ac7cfca2099",
    ("pasta-128s", "plain"): "021dbc05a9e7b35b06bf077da4d1b657558fdb1156173d6c1ccb69e5e58ff586",
    ("pasta-128l", "plain"): "5d8b9aec6b5d50f63d64477d3ff1e45078047c98ed92c4473fc4d0dabcf92331",
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _exact(got, want):
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=0, atol=0)


def _inputs(name, lanes, seed, device):
    p = get_params(name)
    rng = np.random.default_rng(seed)
    q = p.mod.q

    def t(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    key = t(rng.integers(1, q, size=(p.n,)))
    rc = t(rng.integers(0, q, size=(lanes, p.n_round_constants)))
    noise = (t(rng.integers(-16, 17, size=(lanes, p.l)))
             if p.n_noise else None)
    mats = (t(rng.integers(0, q, size=(lanes, p.n_matrix_constants)))
            if p.n_matrix_constants else None)
    return p, key, rc, noise, mats


@pytest.mark.gpu
def test_aes_ctr_kernel_fips197(cuda):
    key = np.arange(16, dtype=np.uint8)
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    out = aes_ctr_kernel_apply(
        aes128_key_expand(key), np.frombuffer(pt[:12], np.uint8),
        torch.tensor([int.from_bytes(pt[12:], "big")], device=cuda))
    assert bytes(out.cpu().numpy()[0]).hex() == \
        "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.gpu
def test_aes_ctr_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    for _ in range(3):
        rk = aes128_key_expand(rng.integers(0, 256, 16, dtype=np.uint8))
        n12 = rng.integers(0, 256, 12, dtype=np.uint8)
        ctr = torch.as_tensor(rng.integers(0, 2**32, 4096), device=cuda)
        _exact(aes_ctr_kernel_apply(rk, n12, ctr), aes_ctr_ref(rk, n12, ctr))


@pytest.mark.gpu
@pytest.mark.parametrize("n_words", [1, 7, 112, 1000])
def test_aes_xof_kernel_matches_plain(cuda, n_words):
    """Several sessions, at lane counts that cut a thread block's lane
    group (and a lane that is shorter than one thread block)."""
    rng = np.random.default_rng(n_words)
    nonces = rng.integers(0, 256, (5, 16), dtype=np.uint8)
    rk = torch.as_tensor(np.stack([aes128_key_expand(n) for n in nonces]),
                         device=cuda)
    n12 = torch.as_tensor(nonces[:, :12].copy(), device=cuda)
    for lanes in LANE_COUNTS:
        sid = torch.as_tensor(rng.integers(0, 5, lanes), device=cuda)
        ctr = torch.as_tensor(rng.integers(0, 2**16, lanes), device=cuda)
        _exact(aes_xof_words(rk, n12, sid, ctr, n_words),
               aes_xof_ref(rk, n12, sid, ctr, n_words))


# the sampler kernels: one warp a row (8 rows a thread block) and one
# thread a draw (256 a thread block); 1003 cuts both
SAMPLER_LANES = (1, 31, 1003)
SAMPLER_SHAPES = [("hera-128a", "rc"), ("rubato-128l", "rc"),
                  ("pasta-128l", "rc"), ("pasta-128l", "mats")]
SAMPLER_KINDS = ("random", "scattered", "all_rejected", "fallback", "high")


def _stream_words(name, plane, kind, lanes, seed):
    """(lanes, w) uint64 words of one sampler stream: random, or built to
    hit an edge of the compaction (the CPU tests' cases)."""
    p = get_params(name)
    n_out = p.n_round_constants if plane == "rc" else p.n_matrix_constants
    w = SMP.words_needed_uniform_stream(n_out)
    words = np.random.default_rng(seed).integers(0, 2**32, (lanes, w),
                                                 dtype=np.uint64)
    rejected = np.uint64(2**32 - 1)          # low `bits` bits >= q
    pad = SMP.STREAM_PAD
    if kind == "scattered":
        words[:, 3:w - pad:max(1, w // 12)] = rejected
    elif kind == "all_rejected":
        words[:] = rejected
    elif kind == "fallback":
        words[:, :5] = rejected
        words[:, -pad - 1:] = rejected
        words[0, 40:60] = rejected
    elif kind == "high":
        words |= np.uint64(2**31)
    return p, n_out, words


def _in_xof_rows(words, dtype, device, offset=5):
    """The words as a column slice of wider XOF rows, as the producer
    hands them over: int32 bit patterns (AES) or int64 values
    (threefry)."""
    lanes, w = words.shape
    full = np.zeros((lanes, w + offset + 3), np.uint64)
    full[:, offset:offset + w] = words
    if dtype == torch.int32:
        t = torch.as_tensor(full.astype(np.uint32).view(np.int32))
    else:
        t = torch.as_tensor(full.astype(np.int64))
    return t.to(device)[:, offset:offset + w]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", SAMPLER_KINDS)
@pytest.mark.parametrize("name,plane", SAMPLER_SHAPES)
def test_sampler_uniform_kernel_matches_plain(cuda, name, plane, kind,
                                              dtype):
    """Word for word against `uniform_mod_q_stream` on the card, the
    words read in place from a slice of the XOF rows."""
    for lanes in SAMPLER_LANES:
        p, n_out, words = _stream_words(name, plane, kind, lanes, lanes)
        view = _in_xof_rows(words, dtype, cuda)
        before = build.LAUNCHES["sampler_uniform"]
        got = uniform_kernel_apply(view, n_out, p.mod)
        assert build.LAUNCHES["sampler_uniform"] == before + 1
        assert got.dtype == torch.int64
        want = SMP.uniform_mod_q_stream(
            torch.as_tensor(words.astype(np.int64), device=cuda), n_out,
            p.mod)
        _exact(got, want)


def _gauss_draws(table, lanes, n, seed):
    """(lanes, n) uint64 (hi, lo) draws: random, then on each threshold,
    one below it, and 0xFFFFFFFF in hi, lo or both."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, lanes * n, dtype=np.uint64)
    lo = rng.integers(0, 2**32, lanes * n, dtype=np.uint64)
    fixed = (table.hi.astype(np.uint64) << np.uint64(32)) \
        | table.lo.astype(np.uint64)
    edges = np.concatenate([fixed, fixed - np.uint64(1),
                            np.array([2**64 - 1, 2**32 - 1,
                                      (2**32 - 1) << 32, 0], np.uint64)])
    k = min(len(edges), hi.size)
    hi[:k] = edges[:k] >> np.uint64(32)
    lo[:k] = edges[:k] & np.uint64(0xFFFFFFFF)
    return hi.reshape(lanes, n), lo.reshape(lanes, n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", ["rubato-128s", "rubato-128l"])
def test_sampler_gauss_kernel_matches_plain(cuda, name, dtype):
    """Word for word against `discrete_gaussian` on the card, hi and lo
    read in place from the XOF rows."""
    p = get_params(name)
    table = SMP.DGaussTable.build(p.sigma)
    n = p.n_noise
    for lanes in SAMPLER_LANES:
        hi, lo = _gauss_draws(table, lanes, n, lanes)
        rows = _in_xof_rows(np.concatenate([hi, lo], 1), dtype, cuda)
        before = build.LAUNCHES["sampler_gauss"]
        got = gauss_kernel_apply(rows[:, :n], rows[:, n:], table)
        assert build.LAUNCHES["sampler_gauss"] == before + 1
        assert got.dtype == torch.int64
        want = SMP.discrete_gaussian(
            torch.as_tensor(hi.astype(np.int64), device=cuda),
            torch.as_tensor(lo.astype(np.int64), device=cuda), table)
        _exact(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("producer", ["aes", "threefry"])
@pytest.mark.parametrize("name", ["hera-128a", "rubato-128l", "pasta-128l"])
def test_card_produce_launches_each_sampler_once(cuda, name, producer):
    """One produce on the card: one launch of each sampler its planes
    need (pasta's matrix plane a second uniform one), and the planes of
    the CPU's plain samplers."""
    import dataclasses

    from repro_torch.core.producer import make_producer

    p = dataclasses.replace(get_params(name), xof=producer)
    rng = np.random.default_rng(9)
    nonces = rng.integers(0, 256, (3, 16), dtype=np.uint8)
    lanes = 37 if name == "pasta-128l" else 1003
    sids = rng.integers(0, 3, lanes)
    ctrs = rng.integers(0, 2**16, lanes)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        prod = make_producer(None, p, device=dev)
        tables = prod.stack_tables([prod.session_material(n)
                                    for n in nonces])
        build.reset_launches()
        out[dev.type] = prod.produce(tables, sids, ctrs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert build.LAUNCHES["sampler_uniform"] == \
                1 + bool(p.n_matrix_constants)
            assert build.LAUNCHES["sampler_gauss"] == int(bool(p.n_noise))
        else:
            assert not any(build.LAUNCHES.values())
    for k, v in out["cpu"].items():
        if v is None:
            assert out["cuda"][k] is None, k
        else:
            _exact(out["cuda"][k], v)


@pytest.mark.gpu
@pytest.mark.parametrize("name", PRESETS)
def test_mrmc_kernel_matches_plain(cuda, name):
    """At lane counts that cut a thread block's group of states."""
    p = get_params(name)
    x = torch.as_tensor(np.random.default_rng(2).integers(
        0, p.mod.q, size=(max(LANE_COUNTS), p.n)), device=cuda)
    for lanes in LANE_COUNTS:
        _exact(mrmc_kernel_apply(p, x[:lanes]), mrmc_ref(p, x[:lanes]))


@pytest.mark.gpu
@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("fill", ["zeros", "q-1"])
def test_mrmc_kernel_edge_values(cuda, name, fill):
    p = get_params(name)
    value = 0 if fill == "zeros" else p.mod.q - 1
    for lanes in LANE_COUNTS:
        x = torch.full((lanes, p.n), value, dtype=torch.int64, device=cuda)
        _exact(mrmc_kernel_apply(p, x), mrmc_ref(p, x))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hera-128a", "rubato-128m", "pasta-128l"])
def test_mrmc_kernel_reads_states_in_place(cuda, name):
    """One launch on the caller's own storage: the only allocation is the
    output, which does not alias the input."""
    p = get_params(name)
    x = torch.as_tensor(np.random.default_rng(3).integers(
        0, p.mod.q, size=(1000, p.n)), device=cuda)
    assert mrmc_operands(p, x).data_ptr() == x.data_ptr()
    before = build.LAUNCHES["mrmc"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    y = mrmc_kernel_apply(p, x)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mrmc"] == before + 1
    assert torch.cuda.max_memory_allocated(cuda) - base == \
        torch.cuda.memory_allocated(cuda) - base >= y.numel() * 8
    assert y.dtype == torch.int64 and y.shape == x.shape
    assert y.is_contiguous() and y.data_ptr() != x.data_ptr()
    _exact(y, mrmc_ref(p, x))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rubato-128s", "pasta-128s"])
def test_mrmc_kernel_strided_input(cuda, name):
    """A column slice of a wider tensor is copied once into contiguous
    states and gives the plain version's words."""
    p = get_params(name)
    wide = torch.as_tensor(np.random.default_rng(4).integers(
        0, p.mod.q, size=(1000, 3 * p.n)), device=cuda)
    view = wide[:, p.n:2 * p.n]
    assert not view.is_contiguous()
    _exact(mrmc_kernel_apply(p, view), mrmc_ref(p, view.contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        launch_mrmc(p, view)


CASES = [(name, variant, reduction, with_noise)
         for name in PRESETS
         for variant in S.VARIANTS
         for reduction in ("lazy", "eager")
         for with_noise in ((False, True) if get_params(name).n_noise
                            else (False,))]


@pytest.mark.gpu
@pytest.mark.parametrize("name,variant,reduction,with_noise", CASES)
def test_keystream_kernel_matches_plain(cuda, name, variant, reduction,
                                        with_noise):
    """At lane counts that cut a lane group and a thread block."""
    for lanes in LANE_COUNTS:
        p, key, rc, noise, mats = _inputs(name, lanes, 3, cuda)
        noise = noise if with_noise else None
        before = build.LAUNCHES["keystream"]
        got = keystream_kernel_apply(p, key, rc, noise, variant=variant,
                                     mats=mats, reduction=reduction)
        assert build.LAUNCHES["keystream"] == before + 1
        _exact(got, keystream_ref(p, key, rc, noise, variant=variant,
                                  mats=mats, reduction=reduction))


@pytest.mark.gpu
@pytest.mark.parametrize("name", PRESETS)
def test_keystream_kernel_reads_planes_in_place(cuda, name):
    """The kernel's operands are the producer's planes on the card (same
    storage), and it returns the engine's row-major int64 keystream."""
    cb = CipherBatch(name, seed=4, device=cuda)
    cb.add_sessions(3)
    k = cb.round_constant_stream(np.array([0, 1, 2, 1]), np.arange(4))
    ops = kernel_operands(cb.params, cb.key, k["rc"], k["noise"],
                          mats=k["mats"])
    for plane in ("rc", "noise", "mats"):
        if k[plane] is not None:
            assert ops[plane].data_ptr() == k[plane].data_ptr(), plane
    z = launch_keystream(cb.params, ops)
    assert z.dtype == torch.int64 and z.shape == (4, cb.params.l)
    assert z.is_contiguous()
    _exact(z, keystream_ref(cb.params, cb.key, k["rc"], k["noise"],
                            mats=k["mats"]))


@pytest.mark.gpu
@pytest.mark.parametrize("name,kind", sorted(GOLDEN))
def test_golden_digests_through_kernels(cuda, name, kind):
    """The reference's golden digests through the AES-kernel producer and
    the fused-kernel engine."""
    c = make_cipher(name, seed=123, engine="cuda", device=cuda)
    k = c.round_constant_stream(np.arange(4))
    z = c.keystream_from_constants(k["rc"], k["noise"] if kind == "noise"
                                   else None, k["mats"])
    digest = hashlib.sha256(
        z.cpu().numpy().astype("<u4").tobytes()).hexdigest()
    assert digest == GOLDEN[(name, kind)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hera-128a", "rubato-128l", "pasta-128s"])
@pytest.mark.parametrize("depth,matrix_depth", [(1, 1), (2, 1), (3, 2)])
def test_card_farm_matches_cpu_farm(cuda, name, depth, matrix_depth):
    """Farm windows on the card (side-stream producer, kernel engine)
    equal the CPU farm's plain path byte for byte, in FIFO order."""
    outs = []
    for device in (cuda, "cpu"):
        cb = CipherBatch(name, seed=5, device=device)
        sessions = cb.add_sessions(6)
        farm = KeystreamFarm(cb, depth=depth, matrix_depth=matrix_depth)
        plans = plan_windows(sessions, 5, window=8)
        outs.append([(p.session_ids.copy(), z.cpu())
                     for p, z in farm.run(plans)])
    for (sa, za), (sb, zb) in zip(*outs):
        np.testing.assert_array_equal(sa, sb)
        _exact(za, zb)


@pytest.mark.gpu
def test_card_server_roundtrip(cuda):
    cb = CipherBatch("rubato-128s", seed=9, device=cuda)
    srv = HHEServer(cb, window=64, engine="cuda", depth=2)
    s = srv.open_session()
    m = (np.arange(40 * cb.params.l).reshape(40, -1) % 97 - 48) / 64.0
    srv.submit(HHERequest(s.index, op="encrypt", payload=m, delta=64.0))
    (enc,) = srv.flush()
    ref = CipherBatch("rubato-128s", key=cb.key.cpu(), device="cpu")
    ref.add_session(s.nonce)
    dec = ref.decrypt(enc.result, np.zeros(40, np.int64), enc.block_ctrs,
                      delta=64.0)
    np.testing.assert_array_equal(dec.numpy(), m.astype(np.float32))


@pytest.mark.gpu
def test_card_serve_plane_with_cpu_client(cuda):
    """A torch `ServePlane` serving from the card to a `ServeClient` whose
    cipher runs on the CPU: both HHE directions and a live rotation,
    exact, with the plane's kernels launched from its worker thread."""
    import asyncio

    from repro_torch.serve.server import ServeClient, ServePlane
    from repro_torch.serve.tenants import TenantRegistry

    reg = TenantRegistry("hera-80", capacity=2, window=64, deadline_s=0.01,
                         device=cuda)

    async def main():
        plane = ServePlane(reg, port=0, tick_s=0.002)
        host, port = await plane.start()
        c = ServeClient(host, port, "t", device="cpu")
        try:
            await c.connect()
            rng = np.random.default_rng(1)
            q, l = c.params.mod.q, c.params.l
            s = await c.open_session()
            toks = rng.integers(0, q, (70, l), dtype=np.uint32)
            r = await c.encrypt_to_server(s, toks)
            assert r["ok"], r
            np.testing.assert_array_equal(r["result"], toks)
            await c.rotate(s)
            r, back = await c.decrypt_from_server(s, toks[:9])
            assert r["ok"] and r["generation"] == 1, r
            np.testing.assert_array_equal(back, toks[:9])
        finally:
            await c.close()
            await plane.stop()

    build.reset_launches()
    asyncio.run(main())
    farm = {k: sum(per[k] for t, per in build.THREAD_LAUNCHES.items()
                   if t.startswith("hhe-farm")) for k in build.LAUNCHES}
    assert farm["keystream"] > 0 and farm["aes_xof"] > 0, farm
    assert reg.peek("t").server.farm.engine.name == "cuda"


@pytest.mark.gpu
def test_card_threefry_matches_reference_digests(cuda):
    """The threefry words, planes and keystream on the card equal the JAX
    reference's digests that chip_smoke.py holds (hera-128a)."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from repro_torch.core.engine import make_engine
    from repro_torch.core.producer import make_producer
    from repro_torch.crypto.xof import threefry_xof_words_batched

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    p = dataclasses.replace(get_params("hera-128a"), xof="threefry")
    nonces, key, sids, ctrs = cs.threefry_lanes(p)
    sids, ctrs = sids[:cs.DIGEST_LANES], ctrs[:cs.DIGEST_LANES]
    want = cs.THREEFRY_GOLDEN["hera-128a"]
    prod = make_producer(None, p, device=cuda)
    tables = prod.stack_tables([prod.session_material(n) for n in nonces])
    sid = torch.as_tensor(sids, device=cuda)
    words = threefry_xof_words_batched(tables.device[0][sid], ctrs,
                                       p.xof_words_per_block())
    assert words.is_cuda and cs.digest(words) == want["words"]
    c = prod.produce(tables, sids, ctrs)
    assert cs.digest(c["rc"]) == want["planes"]
    z = make_engine("cuda", p, key, device=cuda).keystream_from_constants(
        c["rc"], c["noise"], c["mats"])
    _exact(z, make_engine("ref", p, key, device=cuda)
           .keystream_from_constants(c["rc"], c["noise"], c["mats"]))
    assert cs.digest(z) == want["keystream"]


@pytest.mark.gpu
def test_card_autotune_serves_like_the_untuned_server(cuda, tmp_path,
                                                      monkeypatch):
    """A 512-lane autotune over a two-plan grid on the card, its reload,
    "auto" resolving to it, and `HHEServer(plan=)` answering word for word
    as the untuned server on the same pool."""
    from repro_torch.core import tuner as T
    from repro_torch.core.engine import resolve_engine
    from repro_torch.core.producer import make_producer

    cache = tmp_path / "plans.json"
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", str(cache))
    plan = T.autotune("hera-128a", 512, sessions=8, n_windows=2, reps=1,
                      producers=["aes", "cached"], variants=["normal"],
                      windows=[512], depths=[2], reductions=["lazy"],
                      device=cuda)
    assert plan.engine == "cuda" and plan.producer in ("aes", "cached")
    assert T.load_plan("hera-128a", 512, device=cuda) == plan
    assert len(T.load_measurements("hera-128a", 512, device=cuda)) == 2
    p = get_params("hera-128a")
    assert resolve_engine("auto", cuda, p) == "cuda"
    assert make_producer("auto", p, device=cuda).name == plan.producer
    results = []
    for kw in ({"window": 512}, {"plan": plan}):
        cb = CipherBatch("hera-128a", seed=31, device=cuda)
        cb.add_sessions(4)
        srv = HHEServer(cb, **kw)
        for sid, blocks in ((0, 300), (1, 512), (2, 7), (3, 900)):
            srv.submit(HHERequest(sid, op="keystream", blocks=blocks))
        results.append([(r.block_ctrs, r.result) for r in
                        sorted(srv.flush(), key=lambda r: r.seq)])
    for (ca, za), (cb_, zb) in zip(*results):
        np.testing.assert_array_equal(ca, cb_)
        np.testing.assert_array_equal(za, zb)


@pytest.mark.gpu
@pytest.mark.parametrize("name,depth,tol", [
    ("hera-128a", 10, 1 / 2048),
    ("rubato-128l", 2, 10 * 1.6 / 1024 + 1 / 2048),
    ("pasta-128l", 4, 1 / 2048),
])
def test_card_transcipher_depth_and_slots(cuda, name, depth, tol):
    from repro_torch.core.transcipher import transcipher

    ci = make_cipher(name, seed=7, engine="cuda", device=cuda)
    ctrs = np.arange(256)
    m = np.random.default_rng(8).uniform(-4, 4, (256, ci.params.l)) \
        .astype(np.float32)
    ct = ci.encrypt(m, ctrs)
    slots, got_depth = transcipher(ci, ct, ctrs)
    assert got_depth == depth and slots.is_cuda
    err = np.abs(slots.cpu().numpy() - m).max()
    if ci.params.n_noise:
        assert err < tol
    else:
        # the encoded fixed-point slots exactly; a rounding tie sits at
        # exactly half a step
        _exact(slots, ci.decode(ci.encode(m, 1024.0), 1024.0))
        assert err <= tol
    cpu = make_cipher(name, seed=7, device="cpu")
    cpu_slots, _ = transcipher(cpu, ct.cpu(), ctrs)
    _exact(slots.cpu(), cpu_slots)


# ---------------------------------------------------------------------------
# the HHE surface: encode edges, presto_keystream, aes_ctr_keystream, the
# sharded engine
# ---------------------------------------------------------------------------
def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hera-128a", "rubato-128l", "pasta-128l"])
def test_card_encode_edges_are_the_reference_words(cuda, name):
    """Out-of-range, infinite and NaN plaintexts encrypt on the card to the
    JAX reference's words and decrypt to its floats (the digests in
    chip_smoke.py), as on the CPU: no device cast decides them."""
    cs = _chip_smoke()
    ct, pt = cs.encode_edges(cuda, name)
    assert ct.is_cuda and pt.is_cuda
    want = cs.ENCODE_GOLDEN[name]
    assert ct[:, 0].cpu().tolist() == want["word0"]
    assert cs.digest(ct) == want["ct"]
    assert cs.digest(pt.cpu().numpy().view(np.int32)) == want["pt"]
    cpu_ct, cpu_pt = cs.encode_edges(torch.device("cpu"), name)
    _exact(ct, cpu_ct)
    np.testing.assert_array_equal(pt.cpu().numpy().view(np.int32),
                                  cpu_pt.numpy().view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("name,kind", sorted(GOLDEN))
def test_card_presto_keystream_golden_digests(cuda, name, kind):
    import dataclasses

    from repro_torch.core.cipher import Cipher
    from repro_torch.kernels.keystream.ops import presto_keystream

    c = make_cipher(name, seed=123, device=cuda)
    if kind == "plain" and c.params.n_noise:
        c = Cipher(dataclasses.replace(c.params, sigma=0.0), c.key,
                   c.nonce, device=cuda)
    before = dict(build.LAUNCHES)
    z = presto_keystream(c, np.arange(4))
    assert build.LAUNCHES["keystream"] > before["keystream"]
    assert build.LAUNCHES["aes_xof"] > before["aes_xof"]
    digest = hashlib.sha256(
        z.cpu().numpy().astype("<u4").tobytes()).hexdigest()
    assert digest == GOLDEN[(name, kind)]


@pytest.mark.gpu
@pytest.mark.parametrize("counter0,nblocks", [(0, 1), (5, 1000),
                                              (2**32 - 7, 4096)])
def test_card_aes_ctr_keystream_matches_plain(cuda, counter0, nblocks):
    from repro_torch.crypto.aes import aes_ctr_keystream

    rng = np.random.default_rng(nblocks)
    rk = aes128_key_expand(rng.integers(0, 256, 16, dtype=np.uint8))
    nonce = rng.integers(0, 256, 12, dtype=np.uint8)
    before = build.LAUNCHES["aes_ctr"]
    got = aes_ctr_keystream(rk, nonce, counter0, nblocks, device=cuda)
    assert got.is_cuda and build.LAUNCHES["aes_ctr"] == before + 1
    _exact(got, aes_ctr_keystream(rk, nonce, counter0, nblocks,
                                  device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", PRESETS)
def test_card_sharded_engine_matches_cuda_engine(cuda, name):
    cb = CipherBatch(name, seed=6, device=cuda)
    cb.add_sessions(3)
    rng = np.random.default_rng(6)
    k = cb.round_constant_stream(rng.integers(0, 3, 4097),
                                 rng.integers(0, 2**16, 4097))
    for variant in ("normal", "alternating"):
        for reduction in ("lazy", "eager"):
            want_eng = cb.make_engine("cuda", variant=variant,
                                      reduction=reduction)
            eng = cb.make_engine("sharded", devices=[cuda] * 3,
                                 variant=variant, reduction=reduction)
            for lanes in (1, 31, 4097, 4096):
                part = {key: None if v is None else v[:lanes]
                        for key, v in k.items()}
                _exact(eng(part), want_eng(part))


# ---------------------------------------------------------------------------
# the LLM serving path (chip_smoke.py phase 11, at smoke size)
# ---------------------------------------------------------------------------
@pytest.fixture
def no_tf32():
    """float32 on the card means float32 in matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _prefill_and_decode(cfg, model, toks, prompt, steps):
    from repro_torch.models import model as M

    lg, cache, cur = M.prefill(cfg, model, {"tokens": toks[:, :prompt]},
                               prompt + steps)
    out = [lg]
    for i in range(steps):
        cur += 1
        lg, cache = M.decode_step(cfg, model, cache,
                                  toks[:, prompt + i:prompt + i + 1], cur)
        out.append(lg)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-7b", "gemma2-9b",
                                  "granite-3-8b", "internlm2-20b",
                                  "jamba-1.5-large", "mamba2-2.7b",
                                  "mixtral-8x7b", "qwen2-vl-7b"])
def test_card_llm_logits_match_the_cpu_in_float32(cuda, no_tf32, arch):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = M.init_params(cfg, seed=5, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 19)))
    with torch.inference_mode():
        want = _prefill_and_decode(cfg, model, toks, 16, 3)
        model.to(cuda)
        got = _prefill_and_decode(cfg, model, toks.to(cuda), 16, 3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_card_serving_cast_equals_cast_per_use(cuda):
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config("gemma2-9b", smoke=True)
    master = M.init_params(cfg, seed=6, device=cuda)
    served = M.init_params(cfg, seed=6, device=cuda).cast_for_serving()
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 19)), device=cuda)
    with torch.inference_mode():
        for a, b in zip(_prefill_and_decode(cfg, master, toks, 16, 3),
                        _prefill_and_decode(cfg, served, toks, 16, 3)):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("cipher", ["rubato-128l", "pasta-128l"])
def test_card_serve_main_encrypted_launches_the_kernels(cuda, cipher):
    from repro_torch.launch import serve

    build.reset_launches()
    out = serve.main(["--arch", "granite-3-8b", "--smoke", "--batch", "4",
                      "--prompt-len", "32", "--gen", "16", "--encrypted",
                      "--cipher", cipher])
    torch.cuda.synchronize()
    assert build.LAUNCHES["keystream"] > 0 and build.LAUNCHES["aes_xof"] > 0
    assert out["gen"].shape == (4, 16) and out["device"].startswith("cuda")
    assert out["hhe"]["count"] == 8 and out["decode_ms"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cipher", ["hera-128a", "rubato-128l",
                                    "pasta-128l"])
def test_card_channel_client_holds_the_farm_to_the_plain_versions(cuda,
                                                                  cipher):
    """The client's views run on the host and launch nothing, so an exact
    round trip holds the farm's kernels against the plain versions."""
    from repro_torch.launch.serve import EncryptedChannel

    chan = EncryptedChannel(cipher, 3, seed=4, device=cuda)
    prompts = np.random.default_rng(1).integers(0, 49155, (3, 150))
    build.reset_launches()
    cts = chan.client_encrypt(prompts)
    assert sum(build.LAUNCHES.values()) == 0
    got = chan.serve_decrypt_prompts(cts, 150)
    assert build.LAUNCHES["keystream"] > 0 and build.LAUNCHES["aes_xof"] > 0
    np.testing.assert_array_equal(got, prompts)
    gen = prompts[:, :40].astype(np.int32)
    for i, (ct, ctrs) in enumerate(chan.serve_encrypt_responses(gen)):
        np.testing.assert_array_equal(
            chan.client_decrypt(ct, ctrs, i, 40), gen[i])


# ---------------------------------------------------------------------------
# the training path (chip_smoke.py phase 12, at smoke size)
# ---------------------------------------------------------------------------
def _train_batch(cfg, step):
    """A seeded batch as the reference's tests/test_models.py trains each
    arch (embeddings for the frontend archs)."""
    rng = np.random.default_rng(100 + step)
    B, T = 2, 32
    out = {}
    if cfg.frontend == "none":
        out["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    else:
        out["embeds"] = rng.normal(0, 1, (B, T, cfg.frontend_dim)).astype(
            np.float32)
        if cfg.rope_kind == "mrope":
            out["positions"] = np.broadcast_to(
                np.arange(T)[None, :, None], (B, T, 3)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-7b", "gemma2-9b",
                                  "granite-3-8b", "hubert-xlarge",
                                  "internlm2-20b", "jamba-1.5-large",
                                  "mamba2-2.7b", "mixtral-8x7b",
                                  "qwen2-vl-7b"])
def test_card_train_step_matches_the_cpu_in_float32(cuda, no_tf32, arch):
    """Two AdamW steps from the same weights on the same batches, float32
    compute: loss and grad_norm on the card within 1e-4 relative of the
    CPU's (jamba and arctic: bf16 masters and 8-bit moments)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    opt = OptConfig(lr=1e-3, eightbit=cfg.opt_8bit, warmup_steps=1,
                    total_steps=10)
    runs = []
    for dev in ("cpu", cuda):
        model = M.init_params(cfg, seed=9, device="cpu").requires_grad_()
        model.to(dev)
        state = init_opt_state(model, opt)
        step = make_train_step(cfg, opt, device=dev)
        metrics = []
        for i in range(2):
            model, state, m = step(model, state, _train_batch(cfg, i), i)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        runs.append(metrics)
    for (l0, g0), (l1, g1) in zip(*runs):
        assert abs(l1 - l0) <= 1e-4 * abs(l0)
        assert abs(g1 - g0) <= 1e-4 * abs(g0)
    if cfg.opt_8bit:
        assert state["embed"]["m_q"].dtype == torch.int8


@pytest.mark.gpu
def test_card_train_main_encrypted_launches_the_kernels(cuda):
    from repro_torch.launch import train

    build.reset_launches()
    out = train.main(["--arch", "granite-3-8b", "--smoke", "--steps", "3",
                      "--batch", "4", "--seq", "64", "--encrypted",
                      "--cipher", "rubato-128l"])
    torch.cuda.synchronize()
    assert build.LAUNCHES["keystream"] > 0 and build.LAUNCHES["aes_xof"] > 0
    assert out["device"].startswith("cuda") and len(out["history"]) == 3
    for h in out["history"]:
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
        assert h["step_ms"] > 0 and h["decrypt_ms"] > 0
    # one decrypt a step on the card; the client encrypts on the host
    assert build.LAUNCHES["keystream"] == 3 and build.LAUNCHES["aes_xof"] == 3


@pytest.mark.gpu
def test_card_train_run_decrypts_the_plain_encrypt_exactly(cuda):
    """The host's plain encrypt against the card's decrypt, every step."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train

    args = train.parse_args(["--arch", "granite-3-8b", "--smoke", "--steps",
                             "2", "--batch", "3", "--seq", "100",
                             "--encrypted", "--seed", "5"])
    cfg = get_config("granite-3-8b", smoke=True)
    src = SyntheticLM(cfg, 3, 100, seed=5)
    seen = []

    def observe(step, params, batch, metrics):
        want = src.batch_at(step)["tokens"]
        assert np.array_equal(batch["tokens"].cpu().numpy(), want)
        assert np.array_equal(batch["labels"][:, :-1].cpu().numpy(),
                              want[:, 1:])
        seen.append(step)

    train.run(cfg, args, observe=observe)
    assert seen == [0, 1]


# ---------------------------------------------------------------------------
# the sharded path (chip_smoke.py phase 13, at smoke size): a world of one
# rank on NCCL, the reference's (1, 1) host mesh, in this process
# ---------------------------------------------------------------------------
@pytest.fixture
def host_mesh(cuda):
    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    init_distributed(cuda, verbose=False)
    return make_host_mesh(device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-3-8b", "jamba-1.5-large",
                                  "mamba2-2.7b", "mixtral-8x7b"])
def test_card_sharded_serve_steps_match_the_cpu_in_float32(cuda, no_tf32,
                                                           host_mesh, arch):
    """The policy-taking prefill and decode steps (DTensor weights and
    cache, FSDP forced on so the MoE body all-gathers) against the
    one-device steps on the CPU: within 1e-4 absolute, as phase 11's."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_reference, params_to_numpy
    from repro_torch.models.sharding import make_policy
    from repro_torch.serve.serve_loop import make_decode_step, make_prefill_step

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    tree = params_to_numpy(M.init_params(cfg, seed=5, device="cpu"))
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 19))
    runs = []
    for dev, pol in (("cpu", None),
                     (cuda, make_policy(host_mesh, cfg, batch=2, train=False,
                                        hbm_bytes=1.0))):
        model = params_from_reference(cfg, tree, device=dev, policy=pol)
        pre = make_prefill_step(cfg, 19, device=dev, policy=pol)
        dec = make_decode_step(cfg, device=dev, policy=pol)
        lg, cache, cur = pre(model, {"tokens": toks[:, :16]})
        out = [lg]
        for i in range(3):
            cur += 1
            lg, cache = dec(model, cache, toks[:, 16 + i:17 + i], cur)
            out.append(lg)
        runs.append([o.full_tensor().cpu() if hasattr(o, "full_tensor")
                     else o for o in out])
    for g, w in zip(runs[1], runs[0]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-3-8b", "mixtral-8x7b"])
def test_card_sharded_train_step_matches_the_cpu_in_float32(cuda, no_tf32,
                                                            host_mesh, arch):
    """Two AdamW steps with a policy (FSDP and 8-bit moments on) against
    the one-device step on the CPU: loss and grad_norm within 1e-4
    relative, as phase 12's."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_reference, params_to_numpy
    from repro_torch.models.sharding import make_policy
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              opt_8bit=True)
    opt = OptConfig(lr=1e-3, eightbit=True, warmup_steps=1, total_steps=10)
    tree = params_to_numpy(M.init_params(cfg, seed=9, device="cpu"))
    runs = []
    for dev, pol in (("cpu", None),
                     (cuda, make_policy(host_mesh, cfg, batch=2, train=True,
                                        hbm_bytes=1.0))):
        model = params_from_reference(cfg, tree, device=dev,
                                      policy=pol).requires_grad_()
        state = init_opt_state(model, opt)
        step = make_train_step(cfg, opt, device=dev, policy=pol,
                               microbatch=2)
        metrics = []
        for i in range(2):
            model, state, m = step(model, state, _train_batch(cfg, i), i)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        runs.append(metrics)
    for (l0, g0), (l1, g1) in zip(*runs):
        assert abs(l1 - l0) <= 1e-4 * abs(l0)
        assert abs(g1 - g0) <= 1e-4 * abs(g0)


# ---------------------------------------------------------------------------
# the Mamba-2 SSD scan (csrc/ssd.cu) against autograd of the plain version
# ---------------------------------------------------------------------------
# (P, S, chunk) of granite-4.0-h-small and mamba2-2.7b, jamba-1.5-large, the
# smoke variants (chunk 16 and 32)
SSD_SHAPES = [(64, 128, 256), (64, 16, 128), (16, 16, 32), (16, 16, 16)]
SSD_NAMES = ("y", "h_final", "dx", "ddt", "dA", "dB", "dC", "dh0")


def _ssd_inputs(B, T, H, P, S, dtype, with_h0, device, seed, dt=None,
                A=None):
    g = torch.Generator().manual_seed(seed)
    t = {"x": torch.randn(B, T, H, P, generator=g).to(dtype),
         "dt": (torch.rand(B, T, H, generator=g) * 0.1 + 0.01
                if dt is None else torch.full((B, T, H), dt)),
         "A": (-torch.rand(H, generator=g) * 2 - 0.1
               if A is None else torch.full((H,), A)),
         "B": torch.randn(B, T, S, generator=g).to(dtype),
         "C": torch.randn(B, T, S, generator=g).to(dtype),
         "h0": torch.randn(B, H, P, S, generator=g) if with_h0 else None,
         "dy": torch.randn(B, T, H, P, generator=g).to(dtype),
         "dh": torch.randn(B, H, P, S, generator=g)}
    return {k: None if v is None else v.to(device) for k, v in t.items()}


def _ssd_run(fn, t, chunk):
    """y, h_final and the gradients of <y, dy> + <h_final, dh>, float32."""
    names = ["x", "dt", "A", "B", "C"] + (["h0"] if t["h0"] is not None
                                          else [])
    leaves = [t[n].detach().clone().requires_grad_() for n in names]
    y, h = fn(*leaves[:5], chunk, leaves[5] if len(leaves) > 5 else None)
    ((y.float() * t["dy"].float()).sum() + (h * t["dh"]).sum()).backward()
    out = [y.detach().float(), h.detach()] + [v.grad.float() for v in leaves]
    return out + [None] * (len(SSD_NAMES) - len(out))


def _ssd_plain32(x, dt, A, B, C, chunk, h0):
    from repro_torch.models import mamba2 as M2

    return M2.ssd_chunked_plain(x.float(), dt, A, B.float(), C.float(),
                                chunk, h0)


def _ssd_limit(name, dtype):
    """What an output may differ from the plain float32 path's by, as a
    share of the plain output's largest entry: 1e-4 in float32 (dA, a sum
    over T*H*P products that cancel, 1e-3), plus, where the kernel returns
    bfloat16, one rounding of the largest entry: half a bfloat16 unit
    (2^-8) for y, which the plain path keeps in float32, one unit (2^-7)
    for dx, dB and dC, which autograd rounds to the bfloat16 leaves on the
    plain side too."""
    tol = 1e-3 if name == "dA" else 1e-4
    if dtype == torch.bfloat16 and name == "y":
        return tol + 2.0 ** -8
    if dtype == torch.bfloat16 and name in ("dx", "dB", "dC"):
        return tol + 2.0 ** -7
    return tol


def _ssd_close(got, want, dtype):
    """Each output finite and within `_ssd_limit` of the plain float32
    path's largest entry."""
    for name, a, b in zip(SSD_NAMES, got, want):
        if b is None:
            assert a is None, name
            continue
        assert torch.isfinite(a).all(), name
        err = (a - b).abs().max().item()
        assert err <= _ssd_limit(name, dtype) * b.abs().max().item(), \
            (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("short", [False, True])
@pytest.mark.parametrize("P,S,chunk", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, no_tf32, P, S, chunk, short,
                                  with_h0):
    """T = 4 chunks, or a short prefill T < chunk (a ragged L = T)."""
    from repro_torch.kernels.ssd.ops import ssd_kernel_apply

    T = chunk // 2 + 3 if short else 4 * chunk
    for dtype in (torch.float32, torch.bfloat16):
        t = _ssd_inputs(2, T, 3, P, S, dtype, with_h0, cuda, seed=P + S + T)
        got = _ssd_run(ssd_kernel_apply, t, chunk)
        want = _ssd_run(_ssd_plain32, t, chunk)
        _ssd_close(got, want, dtype)


@pytest.mark.gpu
def test_ssd_kernel_nan_free_at_published_widths(cuda, no_tf32):
    """dt 0.1, A -16, L 256: the decay above the diagonal passes exp's
    range; masked before the exp, every output stays finite."""
    from repro_torch.kernels.ssd.ops import ssd_kernel_apply

    t = _ssd_inputs(1, 512, 2, 64, 128, torch.float32, True, cuda, seed=7,
                    dt=0.1, A=-16.0)
    got = _ssd_run(ssd_kernel_apply, t, 256)
    want = _ssd_run(_ssd_plain32, t, 256)
    _ssd_close(got, want, torch.float32)


@pytest.mark.gpu
def test_ssd_kernel_repeats_bit_for_bit(cuda):
    from repro_torch.kernels.ssd.ops import ssd_kernel_apply

    t = _ssd_inputs(1, 512, 4, 64, 128, torch.bfloat16, True, cuda, seed=8)
    a, b = (_ssd_run(ssd_kernel_apply, t, 256) for _ in range(2))
    for name, u, v in zip(SSD_NAMES, a, b):
        assert torch.equal(u, v), name


@pytest.mark.gpu
def test_ssd_launches_in_a_mamba_layer(cuda):
    """One forward and one backward of granite-4.0-h-small's smoke Mamba-2
    layer: one launch each way, on the card's path."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config("granite-4.0-h-small", smoke=True)
    m = M.init_params(cfg, seed=0, device=cuda)
    i = next(j for j, s in enumerate(cfg.group) if s.kind == "mamba")
    p = {k: v[0] for k, v in m.tree()["blocks"][i].items()}
    x = torch.randn(2, 64, cfg.d_model, device=cuda,
                    dtype=M.dtype_of(cfg), requires_grad=True)
    build.reset_launches()
    out, _ = M._mamba_apply(cfg, p, x)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert build.LAUNCHES["ssd_fwd"] == 1 and build.LAUNCHES["ssd_bwd"] == 1
    assert torch.isfinite(x.grad).all()


@pytest.mark.gpu
def test_ssd_kernel_holds_no_chunk_by_chunk_tensor(cuda):
    """At granite-4.0-h-small's widths (T 8192, 128 heads of 64, state
    128, L 256) a forward and backward peak below the size of one
    (chunks, L, L, heads) float32 tensor, which the plain version makes
    several of."""
    from repro_torch.kernels.ssd.ops import ssd_kernel_apply

    t = _ssd_inputs(1, 8192, 128, 64, 128, torch.bfloat16, False, cuda,
                    seed=9)
    leaves = [t[n].requires_grad_() for n in ("x", "dt", "A", "B", "C")]
    one = 32 * 256 * 256 * 128 * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y, _ = ssd_kernel_apply(*leaves, 256)
    torch.autograd.backward([y], [t["dy"]])
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < one
    assert all(torch.isfinite(v.grad).all() for v in leaves)


@pytest.mark.gpu
def test_ssd_kernel_matches_plain_at_granite_widths(cuda, no_tf32):
    """The train cell's shape (T 8192, 128 heads of 64, state 128, L 256)
    in bfloat16: every output and gradient within its limit of the plain
    float32 scan's."""
    from repro_torch.kernels.ssd.ops import ssd_kernel_apply

    t = _ssd_inputs(1, 8192, 128, 64, 128, torch.bfloat16, False, cuda,
                    seed=10)
    got = _ssd_run(ssd_kernel_apply, t, 256)
    torch.cuda.empty_cache()
    want = _ssd_run(_ssd_plain32, t, 256)
    _ssd_close(got, want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,chunk,dtype", [
    ((1, 64, 2, 128, 16), 32, torch.float32),    # P > 64
    ((1, 64, 2, 16, 256), 32, torch.float32),    # S > 128
    ((1, 64, 2, 18, 16), 32, torch.float32),     # P not a multiple of 4
    ((1, 1024, 2, 16, 16), 512, torch.float32),  # L > 256
    ((1, 96, 2, 16, 16), 64, torch.float32),     # L does not divide T
    ((1, 64, 2, 16, 16), 32, torch.float16),
])
def test_ssd_kernel_raises_on_a_shape_it_does_not_take(cuda, shape, chunk,
                                                       dtype):
    from repro_torch.models import mamba2 as M2

    B, T, H, P, S = shape
    t = _ssd_inputs(B, T, H, P, S, dtype, False, cuda, seed=1)
    with pytest.raises(ValueError, match=r"ssd kernel: no kernel for x"):
        M2.ssd_chunked(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk)
