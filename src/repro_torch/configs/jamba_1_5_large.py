"""jamba-1.5-large (398b) [hybrid]: 72L d8192 64H (GQA kv=8) ff24576
v65536 — Mamba+attention 1:7 interleave (attention at slot 3 of each
8-layer block), MoE 16 experts top-2 every other layer.  SSM: state 16
(Jamba's Mamba-1 selective scan realized in the SSD formulation — see
docs/DESIGN.md §8).  bf16 params + 8-bit Adam.  Runs long_500k (sub-quadratic).
[arXiv:2403.19887; hf]"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register


def _group(window=0):
    slots = []
    for i in range(8):
        kind = "attn" if i == 3 else "mamba"
        slots.append(LayerSpec(kind=kind, window=window, moe=(i % 2 == 1)))
    return tuple(slots)


FULL = ModelConfig(
    name="jamba-1.5-large",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    kv_heads=8,
    d_ff=24576,
    vocab=65536,
    group=_group(),
    num_experts=16,
    top_k=2,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    ssm_chunk=128,   # halves the intra-chunk decay tensors at 8192 d_model
    param_dtype="bfloat16",
    opt_8bit=True,
)

SMOKE = ModelConfig(
    name="jamba-1.5-large",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    kv_heads=2,
    d_ff=128,
    vocab=512,
    group=_group(),
    num_experts=4,
    top_k=2,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    conv_width=4,
    ssm_chunk=32,
    param_dtype="bfloat16",
    opt_8bit=True,
    remat=False,
)

register(FULL, SMOKE)
