"""The train loop: a closed loop of train steps of a model configuration,
its token batches shipped as cipher text.

Each step's plaintext is ``batch`` sequences of ``seq_len`` token ids
drawn from the seed by a Zipf law (exponent ``zipf_s``) over the whole
vocabulary, encrypted under one session of the configuration's cipher
through `FarmEncryptedSource.stream()` (one farm window a step, the
farm's depth of steps ahead) and decrypted on the card by the train
step's decryptor (`make_decryptor`) before its forward pass.  The train
step is the program's `make_train_step` (``microbatch`` microbatches,
AdamW at ``lr``), on the configuration's share of the model, its weights
from the seed.  ``warm_steps`` steps warm every shape up; then steps run
back to back for the window.

Correct (each number beside its limit):

- ``wrong_tokens``: decrypted tokens that differ from the plaintext,
  every step;
- ``wrong_words``: keystream words of ``check_blocks_per_step`` blocks a
  step, the cipher text less the plaintext, against the reference's
  cipher (`hhebench.reference.cipher`);
- ``dropped_assignments``: routed assignments to held experts that were
  not computed, as the program's counters give them (``moe.routed``, the
  router's top-k counted apart from the groups the products run on;
  ``moe.computed``, the rows each product ran on), over the program's
  forward passes of every sequence of the window's first step, on its
  parameters, and over the traced stretch;
- the window's first step against `hhebench.reference.granite_moe_hybrid`
  on the parameters as they stood before the window (a copy on the card),
  computed on the card after the window, in float32: the step's loss
  (absolute difference), one sequence's last ``logit_positions`` logits
  and the gradients named in ``grads`` (relative L2 errors), the
  program's gradients those AdamW received in the timed step.

``--control bf16`` puts the reference, computed wholly in bfloat16, in
the program's place in the last comparison.

Besides, ``routes_off_reference`` (a host number, no check): the rows
each held expert computed in the program's forward pass of the first
sequence against the assignments the reference routes there, layer by
layer, the absolute differences summed over the reference's sum.  A
router near-tie that bfloat16 breaks the other way moves an assignment,
so this is a reading and not a limit.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from hhebench.harness import CTR_LIMIT, Cell, Outcome, check_params
from hhebench.reference import cipher as ref_cipher
from hhebench.reference import granite_moe_hybrid as ref
from hhebench.trace import capture

#: configuration-file key -> the program's `ModelConfig` field
FIELDS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
          "num_attention_heads": "num_heads",
          "num_key_value_heads": "kv_heads", "intermediate_size": "d_ff",
          "shared_intermediate_size": "shared_d_ff",
          "vocab_size": "vocab", "experts_total": "num_experts",
          "num_local_experts": "experts_held", "expert_rank": "expert_rank",
          "num_experts_per_tok": "top_k", "mamba_d_state": "ssm_state",
          "mamba_d_head": "ssm_head_dim", "mamba_expand": "ssm_expand",
          "mamba_d_conv": "conv_width", "mamba_chunk_size": "ssm_chunk",
          "mamba_n_heads": "ssm_heads", "mamba_conv_bias": "conv_bias",
          "embedding_multiplier": "embed_mult",
          "residual_multiplier": "residual_mult",
          "logits_scaling": "logits_div",
          "attention_multiplier": "attn_scale", "rms_norm_eps": "norm_eps",
          "tie_word_embeddings": "tie_embeddings"}


def model_config(cfg: dict):
    """The program's configuration of the file's model, cut as the file
    says (its depth and expert share); a width that differs stops the run
    before any work."""
    from repro_torch.configs.base import get_config

    base = get_config(cfg["name"], smoke=cfg.get("smoke", False))
    mcfg = dataclasses.replace(base, num_layers=cfg["num_hidden_layers"],
                               experts_held=cfg["num_local_experts"],
                               expert_rank=cfg["expert_rank"])
    kinds = ["attention" if s.kind == "attn" else "mamba" for s in mcfg.group]
    got = {k: getattr(mcfg, f) for k, f in FIELDS.items()}
    got["layer_types"] = kinds * mcfg.num_groups
    got["head_dim"] = mcfg.resolved_head_dim
    got["dropless"] = mcfg.dropless
    want = {k: cfg[k] for k in FIELDS}
    want.update(layer_types=cfg["layer_types"],
                head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
                dropless=True)
    if got != want:
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise ValueError(f"the program's {cfg['name']} differs from the "
                         f"configuration file (program, file): {bad}")
    return mcfg


class ZipfSource:
    """``{"tokens": (batch, seq_len)}`` of step t: ids drawn from the
    seed and t with P(id = i) proportional to (i + 1)^-s."""

    def __init__(self, seed: int, batch: int, seq_len: int, vocab: int,
                 s: float):
        self.seed, self.batch, self.seq_len = seed, batch, seq_len
        w = np.arange(1, vocab + 1, dtype=np.float64) ** -s
        self.cdf = np.cumsum(w / w.sum())

    def tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, step])
        ids = np.searchsorted(self.cdf, rng.random((self.batch,
                                                    self.seq_len)),
                              side="right")
        return np.minimum(ids, len(self.cdf) - 1)

    def batch_at(self, step: int) -> dict:
        return {"tokens": self.tokens(step)}


class _Trainer:
    def __init__(self, cell: Cell):
        import torch

        from repro_torch.core.cipher import CipherBatch
        from repro_torch.data.encrypted import (
            FarmEncryptedSource,
            make_decryptor,
        )
        from repro_torch.models import model as M
        from repro_torch.train.optimizer import OptConfig, init_opt_state
        from repro_torch.train.train_loop import make_train_step
        from repro_torch.train.tree import leaves_with_paths

        cfg, tr, dev = cell.cfg, cell.traffic, cell.device
        self.dev, self.cfg, self.tr = dev, cfg, tr
        self.mcfg = model_config(cfg)
        t = time.perf_counter()
        rng = np.random.default_rng(cell.seed)
        self.key = rng.integers(1, cfg["q"], size=cfg["n"], dtype=np.int64)
        self.nonce = rng.integers(0, 256, 16, dtype=np.uint8)
        batch = CipherBatch(cfg["cipher"], key=self.key,
                            producer=cfg["producer"], device=dev)
        check_params(batch.params, cfg)
        self.source = ZipfSource(int(rng.integers(0, 2 ** 62)), tr["batch"],
                                 tr["seq_len"], cfg["vocab_size"],
                                 tr["zipf_s"])
        src = FarmEncryptedSource(
            self.source, batch, batch.add_session(nonce=self.nonce),
            engine=cfg["engine"], variant=cfg["variant"], depth=cfg["depth"])
        self.bpb = src.blocks_per_batch()
        self.n_full = tr["batch"] * tr["seq_len"] // cfg["l"]
        self.setup_farm_s = time.perf_counter() - t
        t = time.perf_counter()
        self.model = M.init_params(self.mcfg, seed=int(rng.integers(
            0, 2 ** 62)), device=dev).requires_grad_()
        opt = OptConfig(lr=tr["lr"])
        self.opt_state = init_opt_state(self.model, opt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_model_s = time.perf_counter() - t
        self.step = make_train_step(self.mcfg, opt,
                                    microbatch=tr["microbatch"],
                                    decryptor=make_decryptor(src.cipher),
                                    device=dev)
        self.paths = [p for p, _ in leaves_with_paths(self.model)]
        self.stream = src.stream()
        self.check_rng = np.random.default_rng([cell.seed, 1])
        self.done = 0
        self.wrong_tokens = torch.zeros((), dtype=torch.int64, device=dev)
        self.failed = torch.zeros((), dtype=torch.int64, device=dev)
        self.checked = []       # (step, its checked blocks, their cipher text)
        self.loss = None

    def run(self, stop, observe_first=None):
        """Train steps until ``stop()`` holds after one; the first hands
        its gradients to ``observe_first`` and keeps its loss."""
        import torch

        l, first = self.cfg["l"], True
        while True:
            t = self.done
            if (t + 1) * self.bpb > CTR_LIMIT:
                raise RuntimeError(f"step {t} would pass the nonce's "
                                   f"{CTR_LIMIT} block counters")
            enc = next(self.stream)
            _, _, met = self.step(self.model, self.opt_state, enc, t,
                                  observe=observe_first if first else None)
            if first and observe_first is not None:
                self.loss = met["loss"]
            first = False
            plain = torch.as_tensor(self.source.tokens(t), device=self.dev)
            wrong = (self.step.last_batch["tokens"] != plain).sum()
            self.wrong_tokens += wrong
            self.failed += wrong > 0
            blocks = self.check_rng.choice(
                self.n_full, self.tr["check_blocks_per_step"], replace=False)
            ct = enc["ct"].reshape(-1)[:self.n_full * l].view(self.n_full, l)
            self.checked.append((t, blocks, ct[torch.as_tensor(
                blocks, device=self.dev)]))
            self.done += 1
            if stop():
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def wrong_words(self) -> int:
        """Keystream words of the checked blocks (cipher text less
        plaintext) that differ from the reference cipher's."""
        import torch

        cfg, l = self.cfg, self.cfg["l"]
        ks = ref_cipher.Keystream(cfg, self.key, self.dev)
        got, ctr = [], []
        for t, blocks, ct in self.checked:
            plain = self.source.tokens(t).reshape(-1)[:self.n_full * l]
            plain = torch.as_tensor(plain.reshape(-1, l)[blocks],
                                    device=self.dev)
            got.append((ct - plain) % cfg["q"])
            ctr.append(t * self.bpb + blocks)
        ctr = torch.as_tensor(np.concatenate(ctr), device=self.dev)
        want = ks.keystream(ks.tables(self.nonce[None]),
                            torch.zeros_like(ctr), ctr)
        return int((torch.cat(got) != want).sum())


def ref_params(mcfg, tree: dict) -> dict:
    """The reference's weights from the program's tree, detached (its
    stacks, one layer a slice; the embedding's rows of the vocabulary)."""
    n = len(tree["blocks"])
    layers = [{k: v[i // n].detach() for k, v in tree["blocks"][i % n].items()}
              for i in range(mcfg.num_layers)]
    return {"embed": tree["embed"].detach()[:mcfg.vocab],
            "final_norm": tree["final_norm"].detach(), "layers": layers}


def dropped(records) -> int:
    """Routed assignments to held experts that no product computed, each
    ``moe.routed`` counter against the ``moe.computed`` one of its call;
    a call without the second drops all it routed."""
    routed = [r.value for r in records if r.name == "moe.routed"]
    computed = [r.value for r in records if r.name == "moe.computed"]
    computed += [[]] * (len(routed) - len(computed))
    return sum(max(0, a - (c[e] if e < len(c) else 0))
               for r, c in zip(routed, computed) for e, a in enumerate(r))


def _program_check(mcfg, model, tokens, k: int):
    """The program's forward passes of a step's sequences (S, T), one at
    a time, under a host-only profiler, which turns its counters on: the
    first sequence's last ``k`` logits, the assignments the counters say
    were dropped in any of them, and the rows each held expert computed
    in the first one, layer by layer (its ``moe.computed`` values)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.models import model as M

    n_dropped, logits, computed = 0, None, None
    for seq in tokens:
        t0 = time.time_ns()
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
            out = M.forward_train(mcfg, model, {"tokens": seq[None]})[0]
        recs = [r for r in obs.records() if r.start_ns >= t0]
        n_dropped += dropped(recs)
        if logits is None:
            logits = out[0, -k:, :mcfg.vocab].clone()
            computed = [r.value for r in recs if r.name == "moe.computed"]
        del out
    return logits, n_dropped, computed


def run(cell: Cell) -> Outcome:
    import torch

    from repro_torch.train.tree import leaves_with_paths

    tr, dev = cell.traffic, cell.device
    t0 = time.perf_counter()
    g = _Trainer(cell)
    t_built = time.perf_counter()
    warm_s = []
    while g.done < tr["warm_steps"]:
        t = time.perf_counter()
        g.run(lambda: True)
        warm_s.append(time.perf_counter() - t)
    # the window's first step: its parameters copied on the device (a
    # host copy would take seconds of the set-up), the gradients AdamW
    # receives in it copied too
    snapshot = [p.detach().clone() for _, p in leaves_with_paths(g.model)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n_slots = len(g.mcfg.group)
    wanted = {("blocks", i % n_slots, key): (name, i // n_slots)
              for name, (i, key) in tr["grads"].items()}
    probed = {}

    def observe(grads):
        for path, gr in zip(g.paths, grads):
            if path in wanted:
                name, grp = wanted[path]
                probed[name] = gr[grp].detach().float().clone()

    first = g.done
    t_start = time.perf_counter()
    setup_s = t_start - cell.t_process
    g.run(lambda: time.perf_counter() - t_start >= cell.seconds, observe)
    t_end = time.perf_counter()
    steps = g.done - first
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    host = {"keystream_words_per_s":
            steps * tr["batch"] * tr["seq_len"] / (t_end - t_start),
            "steps": steps, "step_ms": (t_end - t_start) / steps * 1e3,
            "memory_peak_gb": peak / 1e9,
            "setup_build_s": t_built - t0, "setup_farm_s": g.setup_farm_s,
            "setup_model_s": g.setup_model_s,
            "setup_warm_s": t_start - t_built}
    host.update({f"warm_step{i}_s": w for i, w in enumerate(warm_s)})
    trace, n_dropped = None, 0
    if cell.trace:
        from repro_torch import obs

        obs.clear()

        def traced(spans):
            stop = g.done + tr["trace_steps"]
            with spans("hhebench.steps"):
                g.run(lambda: g.done >= stop)
            return tr["trace_steps"], tr["trace_steps"] * g.bpb
        trace = capture(traced, dev, "the train steps")
        n_dropped += dropped([r for r in obs.records()
                              if r.start_ns >= trace.window[0]])
    wrong_tokens, failed = int(g.wrong_tokens), int(g.failed)
    wrong_words = g.wrong_words()
    loss = float(g.loss)

    # the program's state goes; its forward runs on the snapshot
    model, mcfg = g.model, g.mcfg
    toks = torch.as_tensor(g.source.tokens(first), device=dev)
    g = None
    with torch.no_grad():
        for (_, p), s in zip(leaves_with_paths(model), snapshot):
            p.copy_(s)
    del snapshot
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    logits, d, computed = _program_check(mcfg, model, toks,
                                         tr["logit_positions"])
    n_dropped += d
    params = ref_params(mcfg, model.tree())
    del model
    errs = compare(cell, params, toks, loss, logits, probed, computed)
    host["routes_off_reference"] = errs.pop("routes")
    lim = tr["limits"]
    checks = {"wrong_tokens": (wrong_tokens, 0),
              "wrong_words": (wrong_words, 0),
              "dropped_assignments": (n_dropped, 0),
              "loss_abs_err": (errs.pop("loss"), lim["loss_abs_err"]),
              "logits_rel_err": (errs.pop("logits"), lim["logits_rel_err"])}
    for name, e in errs.items():
        checks[f"grad_rel_err.{name}"] = (e, lim["grad_rel_err"][name])
    return Outcome(setup_s, host, steps, failed, checks, peak, trace)


def compare(cell: Cell, params: dict, toks, loss: float, logits,
            grads: dict, computed) -> dict:
    """The window's first step against the reference in float32: the
    loss's absolute error, the logits' and each named gradient's relative
    L2 error, and ``routes``: the held experts' rows of the first
    sequence, layer by layer (``computed``), off the reference's routed
    assignments, over their sum.  Under the control the reference in
    bfloat16 stands in for the program."""
    import torch

    cfg, tr = cell.cfg, cell.traffic
    m, k = tr["microbatch"], tr["logit_positions"]
    # the program's microbatch i: rows i, i + m, ... of the step's batch
    mbs = [toks[i::m] for i in range(m)]
    wrt = {n: tuple(v) for n, v in tr["grads"].items()}
    want_loss, want = ref.step_loss_and_grads(cfg, params, mbs, wrt,
                                              tr["aux_weight"])
    want_logits, routed = ref.last_logits(cfg, params, toks[0], k)
    if cell.control == "bf16":
        loss, grads = ref.step_loss_and_grads(cfg, params, mbs, wrt,
                                              tr["aux_weight"],
                                              torch.bfloat16)
        logits, computed = ref.last_logits(cfg, params, toks[0], k,
                                           torch.bfloat16)
    off = sum(abs(a - b) for c, r in zip(computed, routed)
              for a, b in zip(c, r))
    out = {"loss": abs(loss - want_loss),
           "logits": ref.rel_err(logits.to(want_logits.device), want_logits),
           "routes": off / max(1, sum(map(sum, routed)))}
    for n, w in want.items():
        out[n] = ref.rel_err(grads[n].to(w.device), w)
    return out
