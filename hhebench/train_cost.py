"""The model FLOPs of a train step of the granite-4.0-h-small cell, and
the card's bfloat16 peak.

Copied from the configuration's widths, never from how the program
computes: every count is a product the published equations need, at 2
FLOPs a multiply-add.  Forward and backward are 3 forward passes; a
checkpointed layer's recompute is not counted.  Causal products count
the positions a token attends or scans (the average (n + 1) / 2 of n).
"""

from __future__ import annotations

#: Dense bfloat16 tensor-core peak by `torch.cuda.get_device_name`: the
#: NVIDIA H100 SXM data sheet (700 W), without sparsity.
BF16_FLOPS_PER_S = {"NVIDIA H100 80GB HBM3": 989e12}


def _mamba(c: dict) -> float:
    D, H, P = c["hidden_size"], c["mamba_n_heads"], c["mamba_d_head"]
    S, L, W = c["mamba_d_state"], c["mamba_chunk_size"], c["mamba_d_conv"]
    di = H * P
    proj = 2 * D * (2 * di + 2 * S + H) + 2 * di * D
    conv = 2 * W * (di + 2 * S)
    causal = (L + 1) / 2
    scan = (2 * S * causal            # C_l . B_m inside a chunk
            + 2 * H * P * causal      # the masked form times x
            + 2 * 2 * H * P * S)      # the state: into it, out of it
    return proj + conv + scan


def _attention(c: dict, seq_len: int) -> float:
    D, H, K = (c["hidden_size"], c["num_attention_heads"],
               c["num_key_value_heads"])
    hd = D // H
    proj = 2 * D * (H + 2 * K) * hd + 2 * H * hd * D
    return proj + 2 * 2 * H * hd * (seq_len + 1) / 2


def dense_flops_per_token(c: dict, seq_len: int) -> float:
    """Forward FLOPs a token outside the routed experts: the mixers, the
    routers, the shared experts and the tied head."""
    D = c["hidden_size"]
    total = 2 * D * c["vocab_size"]
    for kind in c["layer_types"]:
        total += _mamba(c) if kind == "mamba" else _attention(c, seq_len)
        total += 2 * D * c["experts_total"]
        total += 2 * 3 * D * c["shared_intermediate_size"]
    return total


def expert_flops_per_assignment(c: dict) -> float:
    """Forward FLOPs of one token in one routed SwiGLU expert."""
    return 2 * 3 * c["hidden_size"] * c["intermediate_size"]


def step_flops(c: dict, tokens: int, seq_len: int, assignments: int) -> float:
    """Forward and backward of ``tokens`` tokens in sequences of
    ``seq_len``, with ``assignments`` routed (token, held expert) pairs
    computed."""
    return 3 * (tokens * dense_flops_per_token(c, seq_len)
                + assignments * expert_flops_per_assignment(c))


def peak_flops(kind: str) -> float:
    if kind not in BF16_FLOPS_PER_S:
        raise KeyError(f"no peak on record for {kind!r}; have "
                       f"{sorted(BF16_FLOPS_PER_S)}")
    return BF16_FLOPS_PER_S[kind]
