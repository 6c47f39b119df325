"""arctic-480b [moe]: 35L d7168 56H (GQA kv=8) ff4864 v32000 — 128 experts
top-2 PLUS a dense-FFN residual branch on every layer.  bf16 params + 8-bit
Adam moments (HBM budget at 512 chips).  [hf:Snowflake/snowflake-arctic-base]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register

FULL = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    kv_heads=8,
    d_ff=4864,
    vocab=32000,
    group=(LayerSpec(moe=True),),
    num_experts=128,
    top_k=2,
    dense_residual=True,
    param_dtype="bfloat16",
    opt_8bit=True,
)

SMOKE = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    kv_heads=2,
    d_ff=96,
    vocab=512,
    group=(LayerSpec(moe=True),),
    num_experts=4,
    top_k=2,
    dense_residual=True,
    param_dtype="bfloat16",
    opt_8bit=True,
    remat=False,
)

register(FULL, SMOKE)
