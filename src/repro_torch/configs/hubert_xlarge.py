"""hubert-xlarge [audio]: 48L d1280 16H (kv=16) ff5120 v504 — encoder-only
(no causal mask, no decode shapes), plain-GELU FFN, conv-feature frontend is
a STUB (input_specs feeds precomputed frame embeddings, dim 512).
[arXiv:2106.07447; unverified]"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    rope_kind="none",
    mlp_gated=False,
    frontend="audio",
    frontend_dim=512,
)

SMOKE = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    kv_heads=4,
    d_ff=128,
    vocab=64,
    causal=False,
    rope_kind="none",
    mlp_gated=False,
    frontend="audio",
    frontend_dim=32,
    remat=False,
)

register(FULL, SMOKE)
