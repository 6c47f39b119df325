"""The port's multi-tenant TCP serving plane against the JAX one: tenant
keys, frame bytes in both codecs, the registry's semantics, and sockets
across the two packages (a JAX client on a torch plane and a torch client
on a JAX plane), every round trip exact."""

import asyncio
import gc
import os
import socket
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.cipher import Cipher as RefCipher  # noqa: E402
from repro.serve import server as RS  # noqa: E402
from repro.serve.tenants import TenantRegistry as RefRegistry  # noqa: E402
from repro.serve.tenants import derive_tenant_key as ref_tenant_key  # noqa: E402

from repro_torch.serve import server as TS  # noqa: E402
from repro_torch.serve.hhe_loop import HHERequest  # noqa: E402
from repro_torch.serve.tenants import (  # noqa: E402
    TenantRegistry,
    derive_tenant_key,
)

CODECS = [TS.CODEC_JSON, TS.CODEC_MSGPACK]
CODEC_IDS = ["json", "msgpack"]


def _need(codec):
    if codec == TS.CODEC_MSGPACK and TS.msgpack is None:
        pytest.skip("msgpack is not installed")


def _registry(**kw):
    kw = {"capacity": 2, "window": 4, "device": "cpu", **kw}
    return TenantRegistry("hera-80", **kw)


def _ref_keystream(params_name, key, nonce, ctrs):
    from repro.core.params import get_params

    return np.asarray(RefCipher(get_params(params_name), key, nonce)
                      .keystream(jnp.asarray(ctrs, jnp.uint32)))


# ---------------------------------------------------------------------------
# tenant keys and frames
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cipher", ["hera-80", "rubato-128l", "pasta-128s"])
@pytest.mark.parametrize("seed", [0, 12345])
def test_derive_tenant_key_matches_reference(cipher, seed):
    for tenant in ("alice", "bob", "tenant-with-a-long-name/7"):
        got = derive_tenant_key(cipher, tenant, seed)
        want = ref_tenant_key(cipher, tenant, seed)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


def _message():
    rng = np.random.default_rng(3)
    return {
        "op": "submit", "id": 17, "tenant": "t", "session": np.int64(2),
        "delta": np.float32(0.5), "flag": True, "none": None,
        "payload": rng.integers(0, 2**31, (3, 4)).astype(np.uint32),
        "nested": {"f": rng.standard_normal((2, 5)).astype(np.float32),
                   "i": np.arange(6, dtype=np.int32).reshape(3, 2),
                   "list": [np.arange(16, dtype=np.uint8), 1.25, "s"],
                   "tuple": (np.uint32(7), np.zeros(0, np.uint32))},
    }


@pytest.mark.parametrize("codec", CODECS, ids=CODEC_IDS)
def test_frame_bytes_match_reference(codec):
    _need(codec)
    msg = _message()
    frame = TS.encode_frame(msg, codec)
    assert frame == RS.encode_frame(msg, codec)
    length, got_codec = TS.HEADER.unpack(frame[:TS.HEADER.size])
    assert (length, got_codec) == (len(frame) - TS.HEADER.size, codec)
    body = frame[TS.HEADER.size:]
    mine, theirs = TS.decode_body(body, codec), RS.decode_body(body, codec)
    for a, b in ((mine["payload"], msg["payload"]),
                 (mine["nested"]["i"], theirs["nested"]["i"]),
                 (mine["nested"]["list"][0], msg["nested"]["list"][0])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert mine["session"] == 2 and mine["none"] is None
    with pytest.raises(ValueError, match="unknown codec"):
        TS.encode_frame(msg, 7)


def test_frame_size_limit():
    big = {"payload": np.zeros(TS.MAX_FRAME // 4 + 1, np.uint32)}
    with pytest.raises(ValueError, match="exceeds"):
        TS.encode_frame(big, TS.CODEC_JSON)


# ---------------------------------------------------------------------------
# registry semantics (tests/test_serve.py, on the port)
# ---------------------------------------------------------------------------
def test_tenant_keys_distinct_and_deterministic():
    reg = _registry(capacity=4)
    ref = RefRegistry("hera-80", capacity=4, window=4, engine="ref")
    k1 = reg.get("alice").batch.key.numpy()
    np.testing.assert_array_equal(k1, np.asarray(ref.get("alice").batch.key))
    assert not np.array_equal(k1, reg.get("bob").batch.key.numpy())
    assert reg.get("alice").batch.device.type == "cpu"


def test_eviction_never_drops_in_flight_tenants():
    reg = _registry(fire_on_fill=False)
    t1, t2 = reg.get("t1"), reg.get("t2")
    for t in (t1, t2):
        s = t.server.open_session()
        t.server.submit(HHERequest(session_id=s.index, blocks=2))
    reg.get("t3")       # both candidates busy -> grow, never evict
    assert len(reg) == 3 and reg.evictions == 0 and reg.busy_overflows == 1
    assert "t1" in reg and "t2" in reg
    with pytest.raises(RuntimeError, match="in-flight"):
        reg.evict("t1")
    t1.server.flush()
    assert not t1.server.busy()
    reg.get("t4")       # drained + collected -> t1 is the LRU idle one
    assert "t1" not in reg and reg.evictions == 1
    assert "t2" in reg and "t3" in reg and "t4" in reg
    stats = reg.stats()
    assert stats["tenants"] == 3 and stats["busy_overflows"] == 1
    assert set(stats["per_tenant"]) == {"t2", "t3", "t4"}


def test_evicted_tenant_reattaches_with_fresh_generation():
    reg = _registry()
    g0 = reg.get("a").generation
    assert reg.evict("a") is True
    assert reg.evict("a") is False
    assert reg.get("a").generation == g0 + 1
    with pytest.raises(KeyError):
        reg.get("zzz", create=False)


def test_eviction_drops_every_reference_to_the_farm():
    """An evicted tenant's pool, farm and server are freed, so their
    device planes go back to the allocator."""
    reg = _registry(capacity=1, deadline_s=0.0)
    t = reg.get("old")
    s = t.server.open_session()
    t.server.submit(HHERequest(session_id=s.index, blocks=6))
    t.server.flush()
    refs = [weakref.ref(x) for x in (t, t.batch, t.server, t.server.farm,
                                     t.server.farm.engine)]
    del t
    reg.get("new")
    gc.collect()
    assert reg.evictions == 1
    assert all(r() is None for r in refs)


def test_rotation_under_concurrent_submits_no_pair_reuse():
    """Submitter threads hammer one session while another thread
    live-rotates it: no (nonce, counter) pair repeats, and every response
    equals the JAX single-stream Cipher under the nonce its counters were
    reserved under."""
    reg = _registry(seed=7)
    tenant = reg.get("spinner")
    srv = tenant.server
    sess = srv.open_session()
    entries, stop, elock = [], threading.Event(), threading.Lock()

    def submitter(seed):
        rng = np.random.default_rng(seed)
        for _ in range(12):
            e = srv.submit_entry(HHERequest(
                session_id=sess.index, op="keystream",
                blocks=int(rng.integers(1, 4))))
            with elock:
                entries.append(e)
            time.sleep(0.001)

    def rotator():
        while not stop.is_set():
            time.sleep(0.01)
            reg.rotate_session("spinner", sess.index)

    threads = [threading.Thread(target=submitter, args=(50 + i,))
               for i in range(3)]
    rot = threading.Thread(target=rotator)
    rot.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    rot.join(timeout=60)
    assert not rot.is_alive() and not any(t.is_alive() for t in threads)
    responses = {r.seq: r for r in srv.flush()}
    assert len(responses) == len(entries) == 36
    key = tenant.batch.key.numpy().astype(np.uint32)
    seen = set()
    for e in entries:
        for c in e.ctrs:
            pair = (e.nonce, int(c))
            assert pair not in seen, "keystream (nonce, counter) reuse"
            seen.add(pair)
    nonces = {e.nonce for e in entries}
    assert len(nonces) > 1
    for nonce in nonces:        # one JAX call per nonce
        mine = [e for e in entries if e.nonce == nonce]
        want = _ref_keystream("hera-80", key, np.frombuffer(nonce, np.uint8),
                              np.concatenate([e.ctrs for e in mine]))
        got = np.concatenate([responses[e.seq].result for e in mine])
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# sockets across the two packages
# ---------------------------------------------------------------------------
async def _round_trips(client, rng, check_raw):
    """Both HHE directions, a live rotation, and the three raw submit
    ops; every result exact.  Returns the rotated session's new nonce."""
    q, l = client.params.mod.q, client.params.l
    s = await client.open_session()
    s2 = await client.open_session()
    toks = rng.integers(0, q, (3, l), dtype=np.uint32)
    r = await client.encrypt_to_server(s, toks)
    assert r["ok"], r
    assert r["result"].dtype == np.int32
    np.testing.assert_array_equal(r["result"], toks)
    old = client.sessions[s]["nonce"].copy()
    await client.rotate(s)              # live rotation over the wire
    assert not np.array_equal(client.sessions[s]["nonce"], old)
    toks = rng.integers(0, q, (5, l), dtype=np.uint32)
    r, back = await client.decrypt_from_server(s, toks)
    assert r["ok"], r
    assert r["generation"] == 1 and r["result"].dtype == np.uint32
    np.testing.assert_array_equal(back, toks)
    toks = rng.integers(0, q, (2, l), dtype=np.uint32)
    r = await client.encrypt_to_server(s, toks)   # mirror after rotation
    assert r["ok"], r
    np.testing.assert_array_equal(r["result"], toks)
    # the other ops, checked against the JAX cipher under the echoed state
    for op, payload in (("keystream", None),
                        ("encrypt", rng.integers(-900, 900, (4, l)) / 1024)):
        msg = {"op": "submit", "tenant": client.tenant, "session": s2,
               "hhe_op": op}
        if payload is None:
            msg["blocks"] = 4
        else:
            msg["payload"] = payload
        r = await client.call(msg)
        assert r["ok"], r
        assert r["result"].dtype == np.uint32
        check_raw(op, r, payload)
    return client.sessions[s]["nonce"]


def _checker(client):
    def check_raw(op, r, payload):
        z = _ref_keystream(client.params.name, client.key, r["nonce"],
                           r["ctrs"]).astype(np.int64)
        if op == "keystream":
            np.testing.assert_array_equal(r["result"], z)
        else:
            q = client.params.mod.q
            mq = (r["result"].astype(np.int64) - z) % q
            signed = np.where(mq > q // 2, mq - q, mq)
            np.testing.assert_array_equal(
                signed, np.round(payload.astype(np.float32) * 1024))
    return check_raw


@pytest.mark.parametrize("codec", CODECS, ids=CODEC_IDS)
def test_jax_client_on_torch_plane(codec):
    _need(codec)

    async def main():
        reg = _registry(deadline_s=0.01)
        plane = TS.ServePlane(reg, port=0, tick_s=0.002)
        host, port = await plane.start()
        client = RS.ServeClient(host, port, "jax-tenant", codec=codec)
        try:
            hello = await client.connect()
            assert hello["key"].dtype == np.uint32
            await _round_trips(client, np.random.default_rng(11),
                               _checker(client))
            stats = await client.stats()
            assert stats["count"] >= 5
            assert (await client.call({"op": "ping"}))["pong"] is True
        finally:
            await client.close()
            await plane.stop()
        tenant = reg.peek("jax-tenant")
        np.testing.assert_array_equal(client.key,
                                      tenant.batch.key.numpy())

    asyncio.run(main())


@pytest.mark.parametrize("codec", CODECS, ids=CODEC_IDS)
def test_torch_client_on_jax_plane(codec):
    _need(codec)

    async def main():
        reg = RefRegistry("hera-80", capacity=2, window=4, engine="ref",
                          deadline_s=0.01)
        plane = RS.ServePlane(reg, port=0, tick_s=0.002)
        host, port = await plane.start()
        client = TS.ServeClient(host, port, "torch-tenant", codec=codec,
                                device="cpu")
        try:
            await client.connect()
            nonce = await _round_trips(client, np.random.default_rng(12),
                                       _checker(client))
            assert (await client.stats())["count"] >= 5
        finally:
            await client.close()
            await plane.stop()
        sess = reg.peek("torch-tenant").batch.sessions[0]
        np.testing.assert_array_equal(sess.nonce, nonce)

    asyncio.run(main())


def test_plane_hello_evicts_an_idle_tenant_and_frees_it():
    """Over the wire: a new tenant's hello at capacity evicts the idle
    one, and nothing of the plane keeps the evicted farm alive."""
    async def main():
        reg = _registry(capacity=1, deadline_s=0.005)
        plane = TS.ServePlane(reg, port=0, tick_s=0.002)
        host, port = await plane.start()
        a = TS.ServeClient(host, port, "a", device="cpu")
        b = TS.ServeClient(host, port, "b", device="cpu")
        try:
            await a.connect()
            s = await a.open_session()
            toks = np.arange(3 * a.params.l).reshape(3, -1)
            r = await a.encrypt_to_server(s, toks)
            np.testing.assert_array_equal(r["result"], toks)
            farm = weakref.ref(reg.peek("a").server.farm)
            await asyncio.sleep(0.02)          # ticks pass over tenant a
            await b.connect()
            gc.collect()
            assert "a" not in reg and reg.evictions == 1
            assert farm() is None
        finally:
            await a.close()
            await b.close()
            await plane.stop()

    asyncio.run(main())


def test_socket_error_paths():
    """Wire errors come back as replies, never dropped connections."""
    async def main():
        plane = TS.ServePlane(_registry(), port=0)
        host, port = await plane.start()
        c = TS.ServeClient(host, port, "t", device="cpu")
        try:
            await c.connect()
            r = await c.call({"op": "nope"})
            assert not r["ok"] and "unknown op" in r["error"]
            r = await c.call({"op": "submit", "tenant": "t", "session": 99,
                              "hhe_op": "keystream", "blocks": 1})
            assert not r["ok"] and "unknown session" in r["error"]
            r = await c.call({"op": "submit", "tenant": "t", "session": 0,
                              "hhe_op": "bogus", "blocks": 1})
            assert not r["ok"] and "unknown op" in r["error"]
            r = await c.call({"op": "hello", "tenant": "t",
                              "cipher": "rubato-128l"})
            assert not r["ok"] and "serves" in r["error"]
            r = await c.call({"op": "rotate", "tenant": "nobody",
                              "session": 0})
            assert not r["ok"] and "KeyError" in r["error"]
            assert (await c.call({"op": "ping"}))["pong"] is True
            stats = (await c.call({"op": "stats"}))["stats"]
            assert stats["tenants"] == 1 and stats["evictions"] == 0
        finally:
            await c.close()
            await plane.stop()

    asyncio.run(main())


def test_server_module_runs_and_answers():
    """``python -m repro_torch.serve.server --device cpu`` serves a ping
    and a hello; without ``--device`` and without a card it refuses."""
    src = str(Path(TS.__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=src)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.server", "--device", "cpu",
         "--port", str(port), "--window", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        assert f"127.0.0.1:{port}" in line and "device=cpu" in line, (
            line, proc.stderr.read() if proc.poll() is not None else "")

        async def ping():
            c = RS.ServeClient("127.0.0.1", port, "cli", codec=TS.CODEC_JSON)
            try:
                hello = await c.connect()
                assert hello["cipher"] == "hera-80" and hello["window"] == 4
                return await c.call({"op": "ping"})
            finally:
                await c.close()

        assert asyncio.run(ping())["pong"] is True
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
    code = ("import torch; torch.cuda.is_available = lambda: False\n"
            "from repro_torch.serve.server import main\n"
            "main(['--port', '0'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode != 0 and 'device="cpu"' in out.stderr
