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
