"""mixtral-8x7b [moe]: 32L d4096 32H (GQA kv=8) ff14336 v32000 — 8 experts
top-2, sliding-window attention (4096).  [arXiv:2401.04088; hf]"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register

FULL = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=32000,
    rope_theta=1e6,
    group=(LayerSpec(window=4096, moe=True),),
    num_experts=8,
    top_k=2,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    kv_heads=2,
    d_ff=128,
    vocab=512,
    rope_theta=1e6,
    group=(LayerSpec(window=16, moe=True),),
    num_experts=4,
    top_k=2,
    remat=False,
)

register(FULL, SMOKE)
