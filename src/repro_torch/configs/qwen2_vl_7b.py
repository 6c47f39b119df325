"""qwen2-vl-7b [vlm backbone]: 28L d3584 28H (GQA kv=4) ff18944 v152064 —
M-RoPE (sections 16/24/24), dynamic-resolution vision frontend is a STUB per
assignment (input_specs feeds precomputed patch embeddings, dim 1280).
[arXiv:2409.12191; hf]"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    kv_heads=4,
    d_ff=18944,
    vocab=152064,
    rope_theta=1e6,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    frontend="vision",
    frontend_dim=1280,
)

SMOKE = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=2,
    d_model=96,
    num_heads=6,     # head_dim 16 -> sections must sum to 8
    kv_heads=2,
    d_ff=192,
    vocab=512,
    rope_theta=1e6,
    rope_kind="mrope",
    mrope_sections=(4, 2, 2),
    frontend="vision",
    frontend_dim=32,
    remat=False,
)

register(FULL, SMOKE)
