"""The port's farm and server against the JAX `KeystreamFarm` and
`HHEServer`, built on the same key and nonces (`batch_from_reference`):
windows in FIFO order at every depth, and every response of a mixed
five-op workload across a session rotation, byte for byte."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.cipher import CipherBatch as RefBatch  # noqa: E402
from repro.core.farm import KeystreamFarm as RefFarm  # noqa: E402
from repro.core.farm import plan_windows as ref_plan_windows  # noqa: E402
from repro.serve.hhe_loop import HHERequest as RefRequest  # noqa: E402
from repro.serve.hhe_loop import HHEServer as RefServer  # noqa: E402
from repro.serve.hhe_loop import HHEServerSaturated as RefSaturated  # noqa: E402

from repro_torch.core.cipher import SESSION_CTR_LIMIT  # noqa: E402
from repro_torch.core.convert import batch_from_reference  # noqa: E402
from repro_torch.core.farm import KeystreamFarm, plan_windows  # noqa: E402
from repro_torch.serve.hhe_loop import (  # noqa: E402
    HHERequest,
    HHEServer,
    HHEServerSaturated,
)

KINDS = ["hera-80", "rubato-128s", "pasta-128s"]   # one preset per cipher


def _pair(name, sessions=4, seed=3):
    """A reference pool and its port twin (same key, nonces, rng state)."""
    ref = RefBatch(name, seed=seed, engine="ref")
    ref.add_sessions(sessions)
    port = batch_from_reference(
        name, np.asarray(ref.key), np.stack([s.nonce for s in ref.sessions]),
        device="cpu")
    port._rng.bit_generator.state = ref._rng.bit_generator.state
    return ref, port


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("depth,matrix_depth", [(1, 1), (2, 1), (2, 2),
                                                (3, 2)])
def test_farm_windows_match_reference(name, depth, matrix_depth):
    ref, port = _pair(name)
    rf = RefFarm(ref, engine="ref", depth=depth, matrix_depth=matrix_depth)
    pf = KeystreamFarm(port, depth=depth, matrix_depth=matrix_depth)
    assert pf.engine.name == "ref"             # "auto" on the CPU
    r_out = list(rf.run(ref_plan_windows(ref.sessions, 5, window=8)))
    p_out = list(pf.run(plan_windows(port.sessions, 5, window=8)))
    assert len(r_out) == len(p_out) == 3
    for (rp, rz), (pp, pz) in zip(r_out, p_out):
        np.testing.assert_array_equal(rp.session_ids, pp.session_ids)
        np.testing.assert_array_equal(rp.block_ctrs, pp.block_ctrs)
        assert rp.valid == pp.valid
        np.testing.assert_array_equal(pz.numpy(),
                                      np.asarray(rz).astype(np.int64))


def test_farm_keystream_and_streams_match_reference():
    ref, port = _pair("rubato-128s")
    rf, pf = RefFarm(ref, engine="ref"), KeystreamFarm(port)
    sids = np.array([0, 1, 2, 3, 1, 0, 2])
    ctrs = np.array([5, 9, 0, 3, 3, 70, 11])
    np.testing.assert_array_equal(
        pf.keystream(sids, ctrs, window=3).numpy(),
        np.asarray(rf.keystream(sids, ctrs, window=3)).astype(np.int64))
    plans = plan_windows(port.sessions, 2, window=8)
    l = port.params.l
    msgs = [np.arange(8 * l).reshape(8, l) / 1024.0 for _ in plans]
    cts = [c for _, c in pf.encrypt_stream(zip(plans, msgs))]
    back = [m for _, m in pf.decrypt_stream(zip(plans, cts))]
    for m, b in zip(msgs, back):
        np.testing.assert_array_equal(b.numpy(), m.astype(np.float32))


def _workload(l, q, rng):
    """All five ops; the third request overruns session 1's counter space
    and forces a rotation."""
    reqs = []
    for sid, op, blocks in [(0, "encrypt", 5), (1, "keystream", 3),
                            (1, "encrypt", 9), (2, "decrypt", 4),
                            (3, "encrypt_tokens", 6), (0, "decrypt_tokens", 2),
                            (2, "keystream", 11)]:
        if op == "encrypt":
            payload = rng.integers(-900, 900, (blocks, l)) / 1024.0
        elif op == "encrypt_tokens":
            payload = rng.integers(0, 50000, (blocks, l))
        elif op in ("decrypt", "decrypt_tokens"):
            payload = rng.integers(0, q, (blocks, l)).astype(np.uint32)
        else:
            payload = None
        reqs.append((sid, op, blocks, payload))
    return reqs


@pytest.mark.parametrize("name", KINDS)
def test_server_responses_match_reference(name):
    ref, port = _pair(name)
    rs = RefServer(ref, window=8, engine="ref", depth=2)
    ps = HHEServer(port, window=8, depth=2)
    for b in (ref, port):             # session 1 is 6 counters from its end
        b.sessions[1].next_ctr = SESSION_CTR_LIMIT - 6
    rng = np.random.default_rng(0)
    reqs = _workload(port.params.l, port.params.mod.q, rng)
    for sid, op, blocks, payload in reqs:
        rc = rs.submit(RefRequest(sid, op=op, payload=payload,
                                  blocks=blocks))
        pc = ps.submit(HHERequest(sid, op=op, payload=payload,
                                  blocks=blocks))
        np.testing.assert_array_equal(rc, pc)
    r_resp, p_resp = rs.flush(), ps.flush()
    assert port.sessions[1].generation == ref.sessions[1].generation == 1
    np.testing.assert_array_equal(port.sessions[1].nonce,
                                  ref.sessions[1].nonce)
    assert len(r_resp) == len(p_resp) == len(reqs)
    for r, p in zip(r_resp, p_resp):
        assert r.request.op == p.request.op
        assert p.result.dtype == np.asarray(r.result).dtype
        np.testing.assert_array_equal(p.result, np.asarray(r.result))
        np.testing.assert_array_equal(p.block_ctrs, r.block_ctrs)
    for k in ("windows_served", "fill_fires", "deadline_fires"):
        assert ps.latency_stats()[k] == rs.latency_stats()[k]


def test_server_deadline_fire_matches_reference():
    ref, port = _pair("hera-80")
    rs = RefServer(ref, window=8, engine="ref", deadline_s=0.05)
    ps = HHEServer(port, window=8, deadline_s=0.05)
    for srv, Req in ((rs, RefRequest), (ps, HHERequest)):
        srv.submit(Req(session_id=2, op="keystream", blocks=3))
    (r,) = rs.service(now=float("inf"))
    (p,) = ps.service(now=float("inf"))
    np.testing.assert_array_equal(p.result, np.asarray(r.result))
    assert ps.latency_stats()["deadline_fires"] == 1
    assert len(ps.window_latencies) == 1


@pytest.mark.parametrize("overload", ["reject", "shed"])
def test_server_admission_control_matches_reference(overload):
    """Over max_pending_lanes a request is rejected or shed before any
    counter is reserved, in both packages alike."""
    ref, port = _pair("hera-80")
    rs = RefServer(ref, window=8, engine="ref", max_pending_lanes=8,
                   overload=overload, fire_on_fill=False)
    ps = HHEServer(port, window=8, max_pending_lanes=8, overload=overload,
                   fire_on_fill=False)
    for srv, Req, Sat in ((rs, RefRequest, RefSaturated),
                          (ps, HHERequest, HHEServerSaturated)):
        assert srv.submit(Req(session_id=0, blocks=6)) is not None
        if overload == "reject":
            with pytest.raises(Sat):
                srv.submit(Req(session_id=0, blocks=3))
        else:
            assert srv.submit(Req(session_id=0, blocks=3)) is None
        assert srv.batch.sessions[0].next_ctr == 6
    stats = ps.latency_stats()
    assert stats["rejected" if overload == "reject" else "shed"] == 1
    (r,), (p,) = rs.flush(), ps.flush()
    np.testing.assert_array_equal(p.result, np.asarray(r.result))
