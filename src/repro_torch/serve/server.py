"""Network-native encrypted serving plane: asyncio TCP front end over the
multi-tenant :class:`repro_torch.serve.tenants.TenantRegistry`.

The port's copy of `repro.serve.server`, with the same wire format, so a
client of either package works against a server of the other:

    PYTHONPATH=src python -m repro_torch.serve.server --cipher hera-80 \\
        --port 7733 [--device cuda]

Wire protocol:

  * every message is a length-prefixed frame: a 5-byte header
    ``struct('>IB')`` = (body length, codec id), then the body;
  * codec 1 is msgpack (preferred when importable), codec 0 is JSON;
    ndarray payloads ride as ``{"__nd__": {dtype, shape, data}}`` with raw
    bytes under msgpack and base64 under JSON, numpy dtype names only —
    the server answers in whatever codec the request used;
  * requests are dicts with an ``op`` and a client-chosen correlation
    ``id``; responses echo ``id``.  Submit responses complete OUT OF
    ORDER: a submit resolves when the window holding its last lane
    materializes.

Request ops: ``hello`` {tenant, cipher?} -> params + the tenant's key (the
trusted-provisioning stand-in of the reference); ``open_session``
{tenant} -> {session, nonce, generation}; ``rotate`` {tenant, session}
-> fresh {nonce, generation}; ``submit`` {tenant, session, hhe_op,
payload?/blocks?, delta?} -> {result, ctrs, nonce, generation,
latency_ms}, or {error: "saturated"} / {shed: true}; ``stats``
{tenant?}; ``ping``.

All farm-touching work (submits, rotations, the deadline tick, stats)
runs on ONE worker thread per plane, so counters are reserved in frame
order.  On the card that thread makes the registry's device its current
CUDA device before its first task: the current device and stream are
per thread, and the farm's side stream and events are driven from the
worker alone.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import concurrent.futures
import json
import struct
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cipher import SESSION_CTR_LIMIT, Cipher, as_int64
from repro_torch.core.params import REGISTRY, get_params
from repro_torch.device import resolve_device
from repro_torch.serve.hhe_loop import HHERequest, HHEServerSaturated
from repro_torch.serve.tenants import TenantRegistry

try:
    import msgpack  # type: ignore
except ImportError:          # an image without msgpack: JSON only
    msgpack = None

HEADER = struct.Struct(">IB")
CODEC_JSON, CODEC_MSGPACK = 0, 1
#: refuse absurd frames before allocating (64 MiB covers any sane window)
MAX_FRAME = 64 << 20
DEFAULT_PORT = 7733


# ==========================================================================
# Frame codec
# ==========================================================================
def _nd_pack(obj, *, binary: bool):
    if isinstance(obj, np.ndarray):
        data = obj.tobytes()
        return {"__nd__": {
            "dtype": str(obj.dtype), "shape": list(obj.shape),
            "data": data if binary else base64.b64encode(data).decode(),
        }}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _nd_pack(v, binary=binary) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_nd_pack(v, binary=binary) for v in obj]
    return obj


def _nd_unpack(obj):
    if isinstance(obj, dict):
        nd = obj.get("__nd__")
        if nd is not None and set(nd) >= {"dtype", "shape", "data"}:
            data = nd["data"]
            if isinstance(data, str):
                data = base64.b64decode(data)
            arr = np.frombuffer(data, dtype=np.dtype(nd["dtype"]))
            return arr.reshape(nd["shape"]).copy()
        return {k: _nd_unpack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_nd_unpack(v) for v in obj]
    return obj


def preferred_codec() -> int:
    return CODEC_MSGPACK if msgpack is not None else CODEC_JSON


def encode_frame(msg: dict, codec: Optional[int] = None) -> bytes:
    codec = preferred_codec() if codec is None else codec
    if codec == CODEC_MSGPACK:
        if msgpack is None:
            raise RuntimeError("msgpack codec requested but not importable")
        body = msgpack.packb(_nd_pack(msg, binary=True), use_bin_type=True)
    elif codec == CODEC_JSON:
        body = json.dumps(_nd_pack(msg, binary=False)).encode()
    else:
        raise ValueError(f"unknown codec {codec}")
    if len(body) > MAX_FRAME:
        raise ValueError(f"frame of {len(body)} bytes exceeds {MAX_FRAME}")
    return HEADER.pack(len(body), codec) + body


def decode_body(body: bytes, codec: int) -> dict:
    if codec == CODEC_MSGPACK:
        if msgpack is None:
            raise ValueError("peer sent msgpack but msgpack is unavailable")
        return _nd_unpack(msgpack.unpackb(body, raw=False))
    if codec == CODEC_JSON:
        return _nd_unpack(json.loads(body.decode()))
    raise ValueError(f"unknown codec {codec}")


async def read_frame(reader: asyncio.StreamReader) -> Tuple[dict, int]:
    """One frame off the stream -> (message, codec it used)."""
    head = await reader.readexactly(HEADER.size)
    length, codec = HEADER.unpack(head)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds {MAX_FRAME}")
    body = await reader.readexactly(length)
    return decode_body(body, codec), codec


# ==========================================================================
# Server
# ==========================================================================
def _bind_device(device: torch.device) -> None:
    """Worker-thread initializer: the CUDA current device is per thread."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


class ServePlane:
    """The asyncio front end: connections in, tenant-registry windows out.

    One instance owns one :class:`TenantRegistry` and one farm-worker
    thread.  Responses to submits resolve through per-(tenant_id,
    tenant_generation, seq) futures: whichever worker call materializes a
    window (a fill-fire inside some submit, the deadline ticker, or a
    rotation quiesce) collects the completed responses and resolves every
    waiter.  Every array a reply carries is a host numpy array.
    """

    def __init__(self, registry: TenantRegistry, host: str = "127.0.0.1",
                 port: int = 0, tick_s: float = 0.005):
        self.registry = registry
        self.host, self.port = host, port
        self.tick_s = tick_s
        self._server: Optional[asyncio.AbstractServer] = None
        self._ticker: Optional[asyncio.Task] = None
        # ONE worker: counter-reservation order == executor queue order ==
        # per-connection frame order
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="hhe-farm",
            initializer=_bind_device, initargs=(registry.device,))
        # (tenant_id, tenant_generation, seq) -> future for a submit
        self._waiters: Dict[tuple, asyncio.Future] = {}
        # responses that materialized before their waiter registered
        self._unclaimed: Dict[tuple, object] = {}
        self.connections = 0
        self.frames = 0

    # ------------------------------------------------------------------
    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._ticker = asyncio.get_running_loop().create_task(
            self._tick_deadlines())
        return self.host, self.port

    async def stop(self) -> None:
        if self._ticker is not None:
            self._ticker.cancel()
            try:
                await self._ticker
            except asyncio.CancelledError:
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._exec.shutdown(wait=True)
        for fut in self._waiters.values():
            if not fut.done():
                fut.cancel()
        self._waiters.clear()
        self._unclaimed.clear()

    async def serve_forever(self) -> None:
        if self._server is None:
            raise RuntimeError("start() first")
        async with self._server:
            await self._server.serve_forever()

    async def _farm(self, fn, *args):
        """Run farm-touching work on the plane's single worker thread."""
        return await asyncio.get_running_loop().run_in_executor(
            self._exec, fn, *args)

    # ------------------------------------------------------------------
    # waiter plumbing (every method here runs on the event-loop thread)
    # ------------------------------------------------------------------
    def _resolve(self, tenant, responses) -> None:
        """Resolve futures for responses a worker call just collected;
        park responses whose waiter isn't registered yet."""
        base = (tenant.tenant_id, tenant.generation)
        for resp in responses:
            key = (*base, resp.seq)
            fut = self._waiters.pop(key, None)
            if fut is None:
                self._unclaimed[key] = resp
            elif not fut.done():
                fut.set_result(resp)

    def _register_waiter(self, tenant, seq: int) -> asyncio.Future:
        key = (tenant.tenant_id, tenant.generation, seq)
        fut = asyncio.get_running_loop().create_future()
        resp = self._unclaimed.pop(key, None)
        if resp is not None:
            fut.set_result(resp)
        else:
            self._waiters[key] = fut
        return fut

    async def _tick_deadlines(self) -> None:
        """The timer edge: each tick, one worker pass services every
        tenant whose deadline may have tripped and collects fill-fired
        completions parked since the last pass."""
        def one_pass():
            out = []
            for tid in self.registry.tenant_ids():
                try:
                    tenant = self.registry.peek(tid)
                except KeyError:
                    continue
                due = tenant.server.next_due()
                if due is not None and time.perf_counter() >= due:
                    done = tenant.server.service()
                else:
                    done = tenant.server.pop_completed()
                if done:
                    out.append((tenant, done))
            return out

        while True:
            await asyncio.sleep(self.tick_s)
            # resolved in a call, so this frame keeps no tenant alive
            # between ticks (an evicted tenant's farm must be freed)
            self._resolve_all(await self._farm(one_pass))

    def _resolve_all(self, batches) -> None:
        for tenant, done in batches:
            self._resolve(tenant, done)

    # ------------------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self.connections += 1
        write_lock = asyncio.Lock()
        pending = set()
        try:
            while True:
                try:
                    msg, codec = await read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                self.frames += 1
                if msg.get("op") == "submit":
                    # submits pipeline: a task each, so later frames on
                    # this connection are parsed while windows fill
                    task = asyncio.get_running_loop().create_task(
                        self._submit_and_reply(
                            msg, codec, writer, write_lock))
                    pending.add(task)
                    task.add_done_callback(pending.discard)
                    continue
                reply = await self._dispatch(msg)
                reply["id"] = msg.get("id")
                async with write_lock:
                    writer.write(encode_frame(reply, codec))
                    await writer.drain()
        finally:
            for task in pending:
                task.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        try:
            if op == "ping":
                return {"ok": True, "pong": True}
            if op == "hello":
                return await self._op_hello(msg)
            if op == "open_session":
                return await self._op_open_session(msg)
            if op == "rotate":
                return await self._op_rotate(msg)
            if op == "stats":
                return await self._op_stats(msg)
            return {"ok": False, "error": f"unknown op {op!r}"}
        except (KeyError, ValueError, RuntimeError) as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    # ---- ops -----------------------------------------------------------
    async def _op_hello(self, msg: dict) -> dict:
        cipher = msg.get("cipher")
        if cipher is not None and cipher != self.registry.cipher:
            return {"ok": False,
                    "error": f"this plane serves {self.registry.cipher!r}, "
                             f"not {cipher!r}"}
        tid = str(msg["tenant"])

        def blocking():
            tenant = self.registry.get(tid)
            return tenant, tenant.batch.key.cpu().numpy().astype(np.uint32)

        tenant, key = await self._farm(blocking)
        p = self.registry.params
        return {
            "ok": True, "tenant": tenant.tenant_id,
            "tenant_generation": tenant.generation,
            "cipher": p.name, "l": p.l, "n": p.n, "q": int(p.mod.q),
            "window": tenant.server.window,
            # trusted-provisioning stand-in (see module docstring)
            "key": key,
        }

    async def _op_open_session(self, msg: dict) -> dict:
        sess = await self._farm(
            self.registry.open_session, str(msg["tenant"]))
        return {"ok": True, "session": sess.index,
                "nonce": sess.nonce, "generation": sess.generation}

    async def _op_rotate(self, msg: dict) -> dict:
        tid, sid = str(msg["tenant"]), int(msg["session"])

        def blocking():
            tenant = self.registry.get(tid, create=False)
            sess = self.registry.rotate_session(tid, sid)
            # the quiesce inside rotate_session may have completed submits
            return tenant, sess, tenant.server.pop_completed()

        tenant, sess, done = await self._farm(blocking)
        self._resolve(tenant, done)
        return {"ok": True, "session": sess.index,
                "nonce": sess.nonce, "generation": sess.generation}

    async def _op_stats(self, msg: dict) -> dict:
        tid = msg.get("tenant")
        if tid is None:
            stats = await self._farm(self.registry.stats)
            return {"ok": True, "stats": stats}
        tenant = self.registry.peek(str(tid))
        stats = await self._farm(tenant.server.latency_stats)
        return {"ok": True, "stats": stats}

    # ---- submit (future-resolved) --------------------------------------
    async def _submit_and_reply(self, msg: dict, codec: int,
                                writer: asyncio.StreamWriter,
                                write_lock: asyncio.Lock) -> None:
        reply = await self._op_submit(msg)
        reply["id"] = msg.get("id")
        try:
            async with write_lock:
                writer.write(encode_frame(reply, codec))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass

    async def _op_submit(self, msg: dict) -> dict:
        try:
            tid = str(msg["tenant"])
            req = HHERequest(
                session_id=int(msg["session"]),
                op=str(msg.get("hhe_op", "keystream")),
                payload=msg.get("payload"),
                blocks=(int(msg["blocks"]) if msg.get("blocks") is not None
                        else None),
                delta=float(msg.get("delta", 1024.0)),
            )
        except (KeyError, ValueError, TypeError) as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

        def blocking():
            tenant = self.registry.get(tid)
            try:
                entry = tenant.server.submit_entry(req)
            except HHEServerSaturated as e:
                return tenant, "saturated", str(e), []
            except (KeyError, RuntimeError, ValueError) as e:
                return tenant, "error", f"{type(e).__name__}: {e}", []
            done = tenant.server.pop_completed()
            if entry is None:
                return tenant, "shed", None, done
            return tenant, "entry", entry, done

        tenant, kind, value, done = await self._farm(blocking)
        if kind == "saturated":
            self._resolve(tenant, done)
            return {"ok": False, "error": "saturated", "detail": value}
        if kind == "error":
            return {"ok": False, "error": value}
        if kind == "shed":
            self._resolve(tenant, done)
            return {"ok": False, "shed": True}
        entry = value
        # register the waiter BEFORE resolving this batch: the entry may
        # already be inside `done` (its own submit filled the window)
        fut = self._register_waiter(tenant, entry.seq)
        self._resolve(tenant, done)
        resp = await fut
        return {
            "ok": True,
            "result": np.asarray(resp.result),
            "ctrs": np.asarray(resp.block_ctrs),
            "nonce": np.frombuffer(entry.nonce, np.uint8).copy(),
            "generation": entry.generation,
            "latency_ms": resp.latency_s * 1e3,
        }


# ==========================================================================
# Client
# ==========================================================================
class ServeClient:
    """Async client for one tenant: frames out, a local cipher for the
    client half of each round trip (encrypt before submit / decrypt
    after).  The local cipher is the port's :class:`Cipher` with the
    ``ref`` engine on ``device`` (None = the card).

    The client mirrors each session's counter cursor so it can encrypt
    BEFORE submitting: the server's single farm worker reserves counters
    in frame order, so as long as ONE connection drives a session and its
    inbound submits are issued in cursor order, the mirror is exact.  The
    outbound direction decrypts under the (nonce, ctrs) echoed in the
    response, so it is exact even across server-side auto-rotations.
    """

    def __init__(self, host: str, port: int, tenant: str,
                 codec: Optional[int] = None, *, device=None):
        self.host, self.port, self.tenant = host, port, tenant
        self.codec = preferred_codec() if codec is None else codec
        self.device = resolve_device(device)
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.params = None
        self.key = None
        self.hello: dict = {}
        self.sessions: Dict[int, dict] = {}   # session -> {nonce, next_ctr}
        self._rid = 0
        self._waiters: Dict[int, asyncio.Future] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._write_lock: Optional[asyncio.Lock] = None
        self._ciphers: Dict[bytes, Cipher] = {}

    # ------------------------------------------------------------------
    async def connect(self) -> dict:
        self.reader, self.writer = await asyncio.open_connection(
            self.host, self.port)
        self._write_lock = asyncio.Lock()
        self._reader_task = asyncio.get_running_loop().create_task(
            self._read_replies())
        hello = await self.call({"op": "hello", "tenant": self.tenant})
        if not hello.get("ok"):
            raise RuntimeError(f"hello failed: {hello}")
        self.hello = hello
        self.params = get_params(hello["cipher"])
        self.key = np.asarray(hello["key"], np.uint32)
        return hello

    async def close(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except asyncio.CancelledError:
                pass
        if self.writer is not None:
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _read_replies(self) -> None:
        try:
            while True:
                msg, _ = await read_frame(self.reader)
                fut = self._waiters.pop(msg.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.CancelledError):
            for fut in self._waiters.values():
                if not fut.done():
                    fut.cancel()
            self._waiters.clear()

    async def call(self, msg: dict) -> dict:
        """Send one frame, await its correlated reply."""
        self._rid += 1
        msg = dict(msg, id=self._rid)
        fut = asyncio.get_running_loop().create_future()
        self._waiters[self._rid] = fut
        async with self._write_lock:
            self.writer.write(encode_frame(msg, self.codec))
            await self.writer.drain()
        return await fut

    # ------------------------------------------------------------------
    async def open_session(self) -> int:
        r = await self.call({"op": "open_session", "tenant": self.tenant})
        if not r.get("ok"):
            raise RuntimeError(f"open_session failed: {r}")
        self.sessions[int(r["session"])] = {
            "nonce": np.asarray(r["nonce"], np.uint8), "next_ctr": 0}
        return int(r["session"])

    async def rotate(self, session: int) -> dict:
        """Live rotation: the server materializes pending old-nonce lanes,
        swaps in a fresh nonce, and the mirror cursor restarts at 0."""
        r = await self.call({"op": "rotate", "tenant": self.tenant,
                             "session": session})
        if not r.get("ok"):
            raise RuntimeError(f"rotate failed: {r}")
        self.sessions[session] = {
            "nonce": np.asarray(r["nonce"], np.uint8), "next_ctr": 0}
        return r

    async def stats(self, tenant_scoped: bool = True) -> dict:
        msg = {"op": "stats"}
        if tenant_scoped:
            msg["tenant"] = self.tenant
        r = await self.call(msg)
        if not r.get("ok"):
            raise RuntimeError(f"stats failed: {r}")
        return r["stats"]

    def _cipher(self, nonce: np.ndarray) -> Cipher:
        """Per-nonce single-stream Cipher (the ref-engine oracle), cached
        so pipelined submits on one session reuse its producer binding."""
        key = np.asarray(nonce, np.uint8).tobytes()
        ci = self._ciphers.get(key)
        if ci is None:
            ci = Cipher(self.params, self.key, nonce, engine="ref",
                        device=self.device)
            self._ciphers[key] = ci
        return ci

    def session_remaining(self, session: int) -> int:
        return SESSION_CTR_LIMIT - self.sessions[session]["next_ctr"]

    # ---- round-trip halves ---------------------------------------------
    async def encrypt_to_server(self, session: int, tokens: np.ndarray
                                ) -> dict:
        """Client-side encrypt, server-side decrypt_tokens: the inbound
        (prompt) HHE direction.  ``tokens``: (blocks, l) ints < q.  The
        reply's ``result`` is the server's recovered plaintext.  Rotates
        the session first when the mirror says the counter space cannot
        fit the request (decrypt-direction submits never auto-rotate
        server-side)."""
        tokens = np.asarray(tokens, np.uint32)
        blocks = tokens.shape[0]
        if blocks > self.session_remaining(session):
            await self.rotate(session)
        st = self.sessions[session]
        ctrs = st["next_ctr"] + np.arange(blocks, dtype=np.uint32)
        st["next_ctr"] += blocks
        z = self._cipher(st["nonce"]).keystream(ctrs)
        ct = self.params.mod.add(as_int64(tokens, z.device), z)
        r = await self.call({
            "op": "submit", "tenant": self.tenant, "session": session,
            "hhe_op": "decrypt_tokens",
            "payload": ct.cpu().numpy().astype(np.uint32),
        })
        if not r.get("ok"):
            # nothing was reserved server-side (shed/reject happen before
            # reservation): roll the mirror back so the cursors re-align
            st["next_ctr"] -= blocks
        return r

    async def decrypt_from_server(self, session: int, tokens: np.ndarray
                                  ) -> Tuple[dict, Optional[np.ndarray]]:
        """Server-side encrypt_tokens, client-side decrypt: the outbound
        (response) HHE direction.  Returns (reply, recovered uint32
        tokens); recovery is exact under the echoed (nonce, ctrs) even
        when the server auto-rotated mid-stream."""
        r = await self.call({
            "op": "submit", "tenant": self.tenant, "session": session,
            "hhe_op": "encrypt_tokens",
            "payload": np.asarray(tokens, np.uint32),
        })
        if not r.get("ok"):
            return r, None
        nonce = np.asarray(r["nonce"], np.uint8)
        ctrs = np.asarray(r["ctrs"], np.uint32)
        z = self._cipher(nonce).keystream(ctrs)
        back = self.params.mod.sub(as_int64(r["result"], z.device), z)
        # re-sync the mirror from the echo (auto-rotation resets it)
        st = self.sessions[session]
        st["nonce"] = nonce
        st["next_ctr"] = int(ctrs[-1]) + 1
        return r, back.cpu().numpy().astype(np.uint32)


# ==========================================================================
# CLI
# ==========================================================================
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="async multi-tenant HHE serving plane (PyTorch port)")
    ap.add_argument("--cipher", default="hera-80", choices=sorted(REGISTRY))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--device", default=None,
                    help="torch device of every tenant (default: the card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--window", type=int, default=64,
                    help="farm window lanes per tenant")
    ap.add_argument("--engine", default=None,
                    help="farm consumer backend (default: auto by device)")
    ap.add_argument("--matrix-depth", type=int, default=None,
                    help="matrix-plane prefetch depth (PASTA)")
    ap.add_argument("--capacity", type=int, default=8,
                    help="live-tenant LRU bound")
    ap.add_argument("--deadline-ms", type=float, default=25.0,
                    help="age bound before a part-full window fires")
    ap.add_argument("--max-pending-lanes", type=int, default=4096,
                    help="admission bound on un-materialized lanes/tenant")
    ap.add_argument("--overload", choices=["reject", "shed"],
                    default="reject")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    registry = TenantRegistry(
        args.cipher, capacity=args.capacity, window=args.window,
        engine=args.engine, matrix_depth=args.matrix_depth,
        deadline_s=args.deadline_ms / 1e3,
        max_pending_lanes=args.max_pending_lanes, overload=args.overload,
        seed=args.seed, device=args.device)

    async def run():
        plane = ServePlane(registry, host=args.host, port=args.port)
        host, port = await plane.start()
        print(f"serving {args.cipher} on {host}:{port} "
              f"(device={registry.device}, window={args.window}, "
              f"deadline={args.deadline_ms}ms, capacity={args.capacity}, "
              f"overload={args.overload}, "
              f"codec={'msgpack' if msgpack else 'json'})", flush=True)
        try:
            await plane.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            await plane.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        print("interrupted; serving plane stopped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
