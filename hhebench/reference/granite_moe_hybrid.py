"""granite-4.0-h-small (GraniteMoeHybrid) in plain PyTorch: the reference
that decides whether the train cell's loss, logits and gradients are
right.

The benchmark's own, written from the published equations: it imports
nothing of the program.  Each sequence is computed on its own; there are
no kernels, no cache and no padding.  Everything comes from the
configuration file (``hhebench/configs/granite-4.0-h-small.json``, the
catalog's keys) and from the weights and tokens it is handed.

Each layer, with h = RMSNorm(x):

    x = x + r * mixer(h)
    h = RMSNorm(x);  x = x + r * (moe(h) + shared(h))

with r = ``residual_multiplier``.  The mixer is Mamba-2 or GQA attention
as ``layer_types`` says; the embeddings are multiplied by
``embedding_multiplier`` and the logits (the tied embedding's) divided by
``logits_scaling``.

- Mamba-2: x, z, B, C and dt are projections of h; x, B and C each pass a
  causal depthwise conv of width ``mamba_d_conv`` with a bias, then SiLU;
  dt = softplus(dt + dt_bias), A = -exp(A_log); per head the state
  S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T and y_t = S_t C_t + D x_t,
  computed here in the plain chunked form of length ``mamba_chunk_size``
  (inside a chunk the masked quadratic form, across chunks the state,
  chunk after chunk); then RMSNorm(y * SiLU(z)) and the out projection.
- Attention: NoPE, causal, softmax scale ``attention_multiplier``,
  ``num_key_value_heads`` KV heads shared by groups of query heads.
- MoE: the router scores all ``experts_total`` experts and keeps the top
  ``num_experts_per_tok``; the gates are the softmax over those logits;
  each expert is SwiGLU of width ``intermediate_size``.  This device holds
  experts [``expert_rank`` x held, ...) (held = ``num_local_experts``):
  their contributions are computed and the others' left out, as the
  program leaves them out.  The shared expert is SwiGLU of width
  ``shared_intermediate_size`` on every token.
- Loss: the mean cross entropy of next-token labels (the last position of
  a sequence has none), plus ``aux_weight`` times the Switch load-balance
  loss E * sum_e f_e P_e over all E experts, averaged over the layers,
  f and P taken over one microbatch's tokens; a step's loss is the mean
  over its microbatches.

Departures from the published model, each also the program's:

- RMSNorm multiplies by (1 + w), w starting at 0, where the published
  model multiplies by w starting at 1: the same function of other
  parameters.
- The in-projection is five matrices (x, z, B, C, dt) in place of one
  fused ``in_proj``, and the conv three (x, B, C) in place of one over
  their concatenation: the same products.
- The weights are random from a seed, not the published checkpoint.

Weights are the program's layout, one layer's slice of each stack:
``{"embed": (V, D), "final_norm": (D,), "layers": [dict]}``, a Mamba-2
layer's dict holding ``norm, w_x, w_z, w_B, w_C, w_dt, conv_x, conv_B,
conv_C, conv_x_b, conv_B_b, conv_C_b, dt_bias, A_log, D_skip, gate_norm,
w_out``, an attention layer's ``norm, wq (D, H, hd), wk, wv, wo (H, hd,
D)``, and every layer's ``norm2, router (D, E), e_wi_g (held, D, F),
e_wi_u, e_wo (held, F, D), s_wi_g (D, Fs), s_wi_u, s_wo (Fs, D)``.

``dtype`` is the precision of every value computed (float32; bfloat16
for the control, with decays, states and softmax statistics in bfloat16
too).  On the card, float32 products run with TF32 off (`exact`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 1024      # attention query rows at a time
CE_BLOCK = 1024     # positions of logits at a time


class exact:
    """Within it, float32 products are float32 on the card: TF32 off for
    matmuls and cuDNN, the settings restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + w)


def swiglu(x, wg, wu, wo):
    return (F.silu(x @ wg) * (x @ wu)) @ wo


# --- Mamba-2 ----------------------------------------------------------------
def causal_conv(u, w, b):
    """u (T, C), w (W, C), b (C,): out_t = b + sum_i w_i u_{t-W+1+i}."""
    W = w.shape[0]
    pad = torch.cat([u.new_zeros(W - 1, u.shape[1]), u])
    T = u.shape[0]
    return b + sum(w[i] * pad[i:i + T] for i in range(W))


def ssd(x, dt, A, B, C, chunk):
    """x (T, H, P), dt (T, H), A (H,), B/C (T, S) -> y (T, H, P), chunk by
    chunk: the masked quadratic form inside, the state across."""
    T, H, P = x.shape
    S = B.shape[1]
    h = x.new_zeros(H, P, S)
    ys = []
    for c0 in range(0, T, chunk):
        xs, ds = x[c0:c0 + chunk], dt[c0:c0 + chunk]
        Bs, Cs = B[c0:c0 + chunk], C[c0:c0 + chunk]
        L = xs.shape[0]
        acs = torch.cumsum(ds * A, 0)                           # (L, H)
        mask = torch.tril(torch.ones(L, L, dtype=torch.bool,
                                     device=x.device))
        # masked before the exp, which overflows above the diagonal
        decay = torch.exp(torch.where(mask[:, :, None],
                                      acs[:, None] - acs[None],
                                      float("-inf")))
        w = decay * (Cs @ Bs.T)[:, :, None] * ds[None]          # (l, m, H)
        y = torch.einsum("lmh,mhp->lhp", w, xs)
        y = y + torch.einsum("ls,hps->lhp", Cs, h) * torch.exp(acs)[..., None]
        into = torch.exp(acs[-1][None] - acs) * ds              # (L, H)
        h = (h * torch.exp(acs[-1])[:, None, None]
             + torch.einsum("mh,mhp,ms->hps", into, xs, Bs))
        ys.append(y)
    return torch.cat(ys)


def mamba(cfg, p, u):
    """One sequence u (T, D) through the Mamba-2 mixer."""
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    T = u.shape[0]
    x = F.silu(causal_conv(u @ p["w_x"], p["conv_x"], p["conv_x_b"]))
    B = F.silu(causal_conv(u @ p["w_B"], p["conv_B"], p["conv_B_b"]))
    C = F.silu(causal_conv(u @ p["w_C"], p["conv_C"], p["conv_C_b"]))
    dt = F.softplus(u @ p["w_dt"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(T, H, P)
    y = ssd(xh, dt, A, B, C, cfg["mamba_chunk_size"])
    y = y + p["D_skip"][:, None] * xh
    y = y.reshape(T, H * P) * F.silu(u @ p["w_z"])
    return rms_norm(y, p["gate_norm"], cfg["rms_norm_eps"]) @ p["w_out"]


# --- attention --------------------------------------------------------------
def _attend(q, k, v, lo, scale):
    """Query rows q (n, H, hd) at positions lo.. against k, v (T, K, hd)."""
    n, H, hd = q.shape
    G = H // k.shape[1]
    hi = lo + n
    kk = k[:hi].repeat_interleave(G, 1)                         # (hi, H, hd)
    vv = v[:hi].repeat_interleave(G, 1)
    s = torch.einsum("qhd,khd->hqk", q, kk) * scale
    pos = torch.arange(hi, device=q.device)
    ok = pos[None] <= (lo + torch.arange(n, device=q.device))[:, None]
    s = torch.where(ok[None], s, torch.finfo(s.dtype).min)
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), vv)


def attention(cfg, p, u):
    """One sequence u (T, D) through causal NoPE GQA attention, a block of
    query rows at a time (each block recomputed in the backward)."""
    T = u.shape[0]
    q = torch.einsum("td,dhe->the", u, p["wq"])
    k = torch.einsum("td,dhe->the", u, p["wk"])
    v = torch.einsum("td,dhe->the", u, p["wv"])
    scale = cfg["attention_multiplier"]
    blocks = []
    for lo in range(0, T, Q_BLOCK):
        qb = q[lo:lo + Q_BLOCK]
        blocks.append(checkpoint(_attend, qb, k, v, lo, scale,
                                 use_reentrant=False)
                      if torch.is_grad_enabled() else
                      _attend(qb, k, v, lo, scale))
    o = torch.cat(blocks)
    return torch.einsum("the,hed->td", o, p["wo"])


# --- the experts ------------------------------------------------------------
def moe(cfg, p, u):
    """Token rows u (N, D) -> (the held experts' part of the MoE output,
    the Switch aux loss, routed assignments to each held expert)."""
    E, k = cfg["experts_total"], cfg["num_experts_per_tok"]
    held = cfg["num_local_experts"]
    e0 = cfg["expert_rank"] * held
    logits = u @ p["router"]                                    # (N, E)
    top, idx = torch.topk(logits, k, -1)
    gates = torch.softmax(top, -1)
    out = torch.zeros_like(u)
    routed = []
    for j in range(held):
        hit = idx == e0 + j                                     # (N, k)
        rows = hit.any(-1).nonzero()[:, 0]
        routed.append(int(rows.numel()))
        g = (gates * hit).sum(-1)[rows]
        y = swiglu(u[rows], p["e_wi_g"][j], p["e_wi_u"][j], p["e_wo"][j])
        out = out.index_add(0, rows, y * g[:, None])
    f = torch.zeros(E, dtype=u.dtype, device=u.device).index_add(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=u.dtype,
                                       device=u.device)) / idx.numel()
    aux = E * (f * torch.softmax(logits, -1).mean(0)).sum()
    return out, aux, routed


# --- the model --------------------------------------------------------------
def layer(cfg, kind, p, x):
    """x (S, T, D), S sequences -> (x, aux, routed)."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    mixer = mamba if kind == "mamba" else attention
    h = rms_norm(x, p["norm"], eps)
    x = x + r * torch.stack([mixer(cfg, p, s) for s in h])
    h = rms_norm(x, p["norm2"], eps)
    rows = h.reshape(-1, h.shape[-1])
    y, aux, routed = moe(cfg, p, rows)
    y = y + swiglu(rows, p["s_wi_g"], p["s_wi_u"], p["s_wo"])
    return x + r * y.reshape(x.shape), aux, routed


def cast(params, dtype):
    """The weights in ``dtype`` (a new tree; tensors already so kept)."""
    return {"embed": params["embed"].to(dtype),
            "final_norm": params["final_norm"].to(dtype),
            "layers": [{n: t.to(dtype) for n, t in p.items()}
                       for p in params["layers"]]}


def hidden(cfg, params, tokens, grad_ckpt=False):
    """tokens (S, T) -> (final hidden (S, T, D) before the last norm,
    mean aux over layers, routed counts per layer)."""
    x = params["embed"][tokens] * cfg["embedding_multiplier"]
    auxes, routed = [], []
    for kind, p in zip(cfg["layer_types"], params["layers"]):
        if grad_ckpt:
            x, a, n = checkpoint(layer, cfg, kind, p, x, use_reentrant=False)
        else:
            x, a, n = layer(cfg, kind, p, x)
        auxes.append(a)
        routed.append(n)
    return x, torch.stack(auxes).mean(), routed


def _ce_block(cfg, params, x, labels):
    logits = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"]) \
        @ params["embed"].T / cfg["logits_scaling"]
    valid = (labels >= 0) & (labels < cfg["vocab_size"])
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    return ((torch.logsumexp(logits, -1) - ll) * valid).sum()


def next_labels(tokens):
    """Each position's label: the next token; the last has none (-1)."""
    return torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], 1)


def microbatch_loss(cfg, params, tokens, aux_weight):
    """Mean next-token cross entropy of the sequences ``tokens`` (S, T)
    plus ``aux_weight`` times their aux loss, with each layer and each
    block of positions recomputed in the backward."""
    x, aux, _ = hidden(cfg, params, tokens, grad_ckpt=True)
    labels = next_labels(tokens)
    nll = 0
    for lo in range(0, tokens.shape[1], CE_BLOCK):
        sl = slice(lo, lo + CE_BLOCK)
        nll = nll + checkpoint(_ce_block, cfg, params, x[:, sl], labels[:, sl],
                               use_reentrant=False)
    n = ((labels >= 0) & (labels < cfg["vocab_size"])).sum()
    return nll / n + aux_weight * aux


def step_loss_and_grads(cfg, params, microbatches, wrt, aux_weight,
                        dtype=torch.float32):
    """The step's loss (mean over ``microbatches``, each (S, T) tokens)
    and its gradients with respect to ``wrt``, a dict of names to
    (layer index or None, key): ``("embed",)`` names a top-level weight.
    Returns (loss, {name: gradient in float32})."""
    with exact():
        p = cast(params, dtype)
        leaves = {}
        for name, (i, key) in wrt.items():
            src = p if i is None else p["layers"][i]
            src[key] = leaves[name] = src[key].detach().requires_grad_()
        total = 0.0
        m = len(microbatches)
        for toks in microbatches:
            loss = microbatch_loss(cfg, p, toks, aux_weight) / m
            loss.backward()
            total += float(loss.detach())
        return total, {n: t.grad.float() for n, t in leaves.items()}


def last_logits(cfg, params, tokens, n, dtype=torch.float32):
    """The logits of the last ``n`` positions of one sequence (T,), and
    the routed assignments to each held expert, layer by layer."""
    with exact(), torch.no_grad():
        p = cast(params, dtype)
        x, _, routed = hidden(cfg, p, tokens[None])
        x = rms_norm(x[0, -n:], p["final_norm"], cfg["rms_norm_eps"])
        return (x @ p["embed"].T / cfg["logits_scaling"]).float(), routed


def sequential_ssd(x, dt, A, B, C):
    """The state-space recurrence token by token (for tests at small
    sizes): S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T, y_t = S_t C_t."""
    T, H, P = x.shape
    h = x.new_zeros(H, P, B.shape[1])
    ys = []
    for t in range(T):
        h = (h * torch.exp(dt[t] * A)[:, None, None]
             + dt[t][:, None, None] * x[t][:, :, None] * B[t][None, None])
        ys.append(h @ C[t])
    return torch.stack(ys)


def rel_err(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp(min=1e-300))

