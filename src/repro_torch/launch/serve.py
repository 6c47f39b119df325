"""Serving entry point: batched prefill + greedy decode with the HHE-encrypted
request path (the client sends HHE-encrypted prompts under any registered
cipher preset — HERA, Rubato or PASTA; the server decrypts them by
keystream subtraction, generates, and re-encrypts the response stream).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --smoke --batch 4 --prompt-len 32 --gen 16 --encrypted [--device cpu]

The port's copy of `repro.launch.serve` (default device: the card).
``--production-mesh`` serves on the reference's (16, 16) mesh and raises,
naming the world it needs, in any other world; ``--mesh D,M`` (or
``P,D,M``) lays a mesh over the launched world (``torchrun``; a world of
several ranks needs one of the two, and each rank takes the card of its
``LOCAL_RANK`` unless ``--device`` names one), and :func:`run` takes a
``DeviceMesh``.  On a mesh every rank runs this
(SPMD) with DTensor weights laid out by the sharding policy; rank 0
holds the :class:`EncryptedChannel`, its decrypted tokens reach the other
ranks through ``distribute_tensor``, and the round trips are checked on
rank 0.  The encrypted path is farm-backed: the server holds ONE symmetric
key in a :class:`repro_torch.core.cipher.CipherBatch` pool with one
`StreamSession` per batch lane, and every keystream materialization —
prompt decryption AND response re-encryption — runs through the
:class:`repro_torch.serve.hhe_loop.HHEServer` window scheduler over the
depth-buffered `KeystreamFarm` (on the card: the AES-kernel producer and
the fused keystream kernel).  The pipeline tuple can come from a measured
`repro_torch.core.tuner.StreamPlan`: --autotune measures one for this
serving shape and persists it; --plan serves from a persisted cache.
Clients encrypt/decrypt with their own session's single-stream view
(`CipherBatch.session_cipher`) on the host, with the plain engine and
producer, as a client without the key's card would — bit-exact with the
farm by contract, so each round trip holds the card's kernels against
their plain versions at the serving shapes.

The model's matmul weights are cast to the compute dtype once, when it is
built (:meth:`repro_torch.models.model.Model.cast_for_serving`).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.core.cipher import CipherBatch, add_words, as_int64, sub_words
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_distributed, launch_mesh
from repro_torch.models import model as M
from repro_torch.models.sharding import make_policy
from repro_torch.serve.hhe_loop import HHERequest, HHEServer
from repro_torch.serve.serve_loop import make_decode_step, make_prefill_step


#: where the client's single-stream views run: the host, whatever device
#: serves (the client holds no card)
CLIENT_DEVICE = torch.device("cpu")


def _pack_tokens(tokens_1d, l: int) -> np.ndarray:
    """(T,) token ids -> (blocks, l) uint32, zero-padded to whole blocks."""
    t = np.asarray(tokens_1d).reshape(-1)
    nblk = -(t.shape[0] // -l)  # ceil
    out = np.zeros(nblk * l, np.uint32)
    out[: t.shape[0]] = t.astype(np.uint32)
    return out.reshape(nblk, l)


class EncryptedChannel:
    """The farm-backed HHE request path for one serving batch.

    Server role: an :class:`HHEServer` (one symmetric key, one session per
    batch lane, fixed-window farm scheduling).  Client role: per-lane
    single-stream encrypt/decrypt via ``session_cipher`` on the host — the
    two sides share only (key, nonce, counters), never keystream material
    over the wire.  Keys and nonces come from ``seed`` as the reference draws them,
    so the same seed gives the reference's ciphertexts word for word.
    """

    def __init__(self, cipher_name: str, batch: int, engine: str = "auto",
                 window: int = 0, seed: int = 0, variant: str = "auto",
                 plan=None, device=None):
        self.batch = CipherBatch(cipher_name, seed=seed, device=device)
        self.device = self.batch.device
        self.lanes = batch
        self.l = self.batch.params.l
        self.mod = self.batch.params.mod
        # window: one wave of per-lane prompt blocks by default, so a whole
        # prefill's decryption is a handful of shape-stable windows
        self.window = window
        self.server: HHEServer | None = None
        self.engine = engine
        self.variant = variant
        # a measured StreamPlan overrides engine/variant and supplies
        # producer + FIFO depth + window in one shot
        self.plan = plan
        for _ in range(batch):
            self.batch.add_session()

    def _server(self, blocks_hint: int) -> HHEServer:
        if self.server is None:
            if self.plan is not None:
                # honor the plan's measured window unless --window overrode
                self.server = HHEServer(self.batch,
                                        window=self.window or None,
                                        plan=self.plan)
            else:
                w = self.window or max(1, self.lanes * blocks_hint)
                self.server = HHEServer(self.batch, window=w,
                                        engine=self.engine,
                                        variant=self.variant)
            self.server.warmup()
        return self.server

    # ---- client role ----------------------------------------------------
    def client_encrypt(self, tokens) -> list:
        """(B, T) token ids -> per-lane (blocks, l) u32 ciphertext, lane i
        encrypted under session i's nonce on that session's next counters
        (read from the live cursor, so multi-turn channels stay aligned
        with the server's take_window reservations).

        The client owns its nonce: when a lane's counter space cannot fit
        the prompt, the client rotates the session BEFORE encrypting
        (fresh nonce, cursor 0) — never encrypts past the limit, which
        would alias earlier XOF streams (keystream reuse).
        """
        cts = []
        for i in range(self.lanes):
            pt = _pack_tokens(tokens[i], self.l)
            sess = self.batch.sessions[i]
            if pt.shape[0] > sess.remaining():
                # turn boundaries flush fully, so no server work is
                # pending against the old nonce here
                if self.server is not None:
                    self.server.flush()
                sess = self.batch.rotate_session(i)
                if pt.shape[0] > sess.remaining():
                    raise RuntimeError(
                        f"prompt of {pt.shape[0]} blocks exceeds a whole "
                        "session's counter space; split it across windows"
                    )
            ci = self.batch.session_cipher(i, device=CLIENT_DEVICE)
            ctrs = np.arange(sess.next_ctr, sess.next_ctr + pt.shape[0],
                             dtype=np.uint32)
            z = ci.keystream(ctrs)
            ct = add_words(self.mod, as_int64(pt, CLIENT_DEVICE), z)
            cts.append(ct.numpy().astype(np.uint32))
        return cts

    def client_decrypt(self, ct, block_ctrs, lane: int,
                       n_tokens: int) -> np.ndarray:
        """Decrypt one lane's (blocks, l) u32 response at the server-issued
        counters; returns (n_tokens,) int32."""
        ci = self.batch.session_cipher(lane, device=CLIENT_DEVICE)
        z = ci.keystream(np.asarray(block_ctrs, np.uint32))
        toks = sub_words(self.mod, as_int64(ct, CLIENT_DEVICE), z)
        return toks.numpy().reshape(-1)[:n_tokens].astype(np.int32)

    # ---- server role (everything runs through hhe_loop windows) ---------
    def serve_decrypt_prompts(self, cts: list, prompt_len: int) -> np.ndarray:
        """Ciphertext prompts -> (B, T) int32 token batch, via one farm
        flush."""
        srv = self._server(blocks_hint=cts[0].shape[0])
        for i, ct in enumerate(cts):
            srv.submit(HHERequest(session_id=i, op="decrypt_tokens",
                                  payload=ct))
        resps = srv.flush()
        return np.stack([
            r.result.reshape(-1)[:prompt_len] for r in resps
        ]).astype(np.int32)

    def serve_encrypt_responses(self, gen: np.ndarray) -> list:
        """(B, T_gen) generated tokens -> per-lane (ciphertext, block_ctrs),
        re-encrypted through the same farm windows."""
        srv = self._server(blocks_hint=_pack_tokens(gen[0], self.l).shape[0])
        for i in range(self.lanes):
            srv.submit(HHERequest(session_id=i, op="encrypt_tokens",
                                  payload=_pack_tokens(gen[i], self.l)))
        return [(r.result, r.block_ctrs) for r in srv.flush()]

    def latency_stats(self) -> dict:
        if self.server is not None:
            return self.server.latency_stats()
        # same zeroed shape HHEServer.latency_stats() guarantees pre-traffic
        return {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0,
                "queue_depth_lanes": 0, "inflight_lanes": 0,
                "windows_served": 0, "fill_fires": 0, "deadline_fires": 0,
                "shed": 0, "rejected": 0}


def _span(dev: torch.device):
    """Start a span on ``dev``; the returned function gives its ms once the
    work queued in it is done (CUDA events on the card, the host clock on
    the CPU)."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()

        def stop():
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
    else:
        t0 = time.perf_counter()

        def stop():
            return (time.perf_counter() - t0) * 1e3
    return stop


def parse_args(argv=None) -> argparse.Namespace:
    from repro_torch.core.params import REGISTRY as _CIPHERS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--encrypted", action="store_true")
    ap.add_argument("--cipher", default="rubato-128l",
                    choices=sorted(_CIPHERS),
                    help="HHE cipher preset for --encrypted (any "
                         "registered kind: hera / rubato / pasta)")
    ap.add_argument("--engine", default="auto",
                    help="keystream engine for --encrypted "
                         "(see repro_torch.core.engine; 'auto' resolves "
                         "per device)")
    ap.add_argument("--window", type=int, default=0,
                    help="farm window lanes for --encrypted "
                         "(0 = one prompt wave)")
    ap.add_argument("--schedule-variant", default="auto",
                    choices=["auto", "normal", "alternating"],
                    help="cipher schedule-orientation plan for --encrypted "
                         "(core/schedule.py; 'auto' = engine preference)")
    ap.add_argument("--plan", default=None,
                    help="StreamPlan JSON cache to serve --encrypted from "
                         "(repro_torch.core.tuner; looked up by preset, "
                         "host and device)")
    ap.add_argument("--autotune", action="store_true",
                    help="measure a StreamPlan for this serving shape "
                         "before taking traffic (persisted to the tuner "
                         "cache; overrides --engine/--schedule-variant)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "the plain PyTorch path on the host)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's (16, 16) mesh: a world of 256")
    ap.add_argument("--mesh", default=None,
                    help="mesh shape D,M or P,D,M over the launched world")
    return ap.parse_args(argv)


def run(cfg, args: argparse.Namespace, mesh=None) -> dict:
    """Serve one batch of ``cfg`` as ``args`` say (a ``ModelConfig``, so a
    full config cut in depth runs in process); prints the reference's
    lines and returns ``{"gen": (B, gen) int32 tokens, "prompts",
    "prefill_ms", "decode_ms", "decode_steps", "tokens_per_s",
    "weight_bytes", "cache_bytes", "hhe": window latency stats or None,
    "device", "policy", "logits0": the prefill's last logits (float32,
    on the host)}`` (times from CUDA events on the card).  ``mesh`` (a
    ("data", "model") ``DeviceMesh`` over the started world) serves
    sharded by the policy of ``cfg`` on it."""
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (on the command line: --device cpu)") from e

    if not cfg.causal:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode serving")
    if mesh is None:
        mesh = launch_mesh(args.production_mesh, args.mesh, args.device)
    policy = None
    if mesh is not None:
        # this rank's card: the one asked for, else cuda:LOCAL_RANK
        dev = init_distributed(args.device, verbose=False)
        policy = make_policy(mesh, cfg, batch=args.batch, train=False,
                             seq_len=args.prompt_len + args.gen)
    lead = dist.get_rank() == 0 if dist.is_initialized() else True
    say = print if lead else (lambda *a, **k: None)
    max_len = args.prompt_len + args.gen

    prefill = make_prefill_step(cfg, max_len, device=dev, policy=policy)
    decode = make_decode_step(cfg, device=dev, policy=policy)

    params = M.init_params(cfg, seed=args.seed, device=dev,
                           policy=policy).cast_for_serving()
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    if policy is not None:
        say(f"sharded: mesh {dict(policy.axes)}, {policy.describe()}, "
            f"backend {dist.get_backend()}")

    chan = None
    if args.encrypted and lead:
        plan = None
        if args.plan or args.autotune:
            from repro_torch.core.params import get_params
            from repro_torch.core.tuner import autotune, load_plan

            # the serving window shape: one wave of per-lane prompt blocks
            cl = get_params(args.cipher).l
            lanes = args.window or max(
                1, args.batch * (-(args.prompt_len // -cl)))
            if args.autotune:
                plan = autotune(args.cipher, lanes, sessions=args.batch,
                                cache_path=args.plan, verbose=True,
                                device=dev)
            else:
                plan = load_plan(args.cipher, lanes, cache_path=args.plan,
                                 device=dev)
                if plan is None:
                    raise SystemExit(
                        f"no StreamPlan cached for {args.cipher}/"
                        f"lanes={lanes} on this host in "
                        f"{args.plan} — run with --autotune first")
            say(f"serving from measured StreamPlan: {plan.describe()}")
        chan = EncryptedChannel(args.cipher, args.batch, engine=args.engine,
                                window=args.window, seed=args.seed,
                                variant=args.schedule_variant, plan=plan,
                                device=dev)
        cts = chan.client_encrypt(prompts)                 # client side
        tokens = chan.serve_decrypt_prompts(cts, args.prompt_len)
        np.testing.assert_array_equal(tokens, prompts)
        say(f"prompts arrived HHE-encrypted; decrypted through "
              f"KeystreamFarm windows (engine={chan.server.farm.engine.name}"
              f", schedule={chan.server.farm.engine.variant}"
              f", producer={chan.batch.producer.name}"
              f", depth={chan.server.farm.depth}"
              f", window={chan.server.window}, "
              f"{args.batch} sessions)")
    elif args.encrypted:
        tokens = np.zeros_like(prompts)      # rank 0's arrive by scatter
    else:
        tokens = prompts
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64)}

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    t0 = time.time()
    span = _span(dev)
    logits, cache, cur_len = prefill(params, batch)
    logits = whole(logits)
    prefill_ms = span()
    say(f"prefill {args.batch}x{args.prompt_len}: {time.time()-t0:.3f}s")
    logits0 = logits[:, -1].float().cpu()

    toks = torch.argmax(logits[:, -1:], dim=-1)
    out = [toks]
    t0 = time.time()
    span = _span(dev)
    for _ in range(args.gen - 1):
        cur_len = cur_len + 1
        logits, cache = decode(params, cache, toks, cur_len)
        toks = torch.argmax(whole(logits)[:, -1:], dim=-1)
        out.append(toks)
    decode_ms = span()
    dt = time.time() - t0
    gen = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
    say(f"decoded {args.gen-1} steps in {dt:.3f}s "
        f"({(args.gen-1)*args.batch/max(dt,1e-9):.1f} tok/s)")
    say("sample:", gen[0][:16])

    stats = None
    if chan is not None:
        enc = chan.serve_encrypt_responses(gen)            # server side
        for i, (ct, ctrs) in enumerate(enc):               # client side
            back = chan.client_decrypt(ct, ctrs, i, gen.shape[1])
            np.testing.assert_array_equal(back, gen[i])
        stats = chan.latency_stats()
        say(f"responses re-encrypted through the farm; round-trip "
            f"verified client-side ({len(enc)} lanes)")
        say(f"HHE window latency: count={stats['count']} "
            f"p50={stats['p50_ms']:.2f}ms p99={stats['p99_ms']:.2f}ms")
    steps = args.gen - 1
    return {"gen": gen, "prompts": prompts, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "decode_steps": steps,
            "tokens_per_s": steps * args.batch / max(decode_ms / 1e3, 1e-12),
            "weight_bytes": params.weight_bytes(),
            "cache_bytes": M.cache_bytes(cache), "hhe": stats,
            "device": str(dev), "policy": policy, "logits0": logits0}


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(get_config(args.arch, smoke=args.smoke), args)


if __name__ == "__main__":
    main()
