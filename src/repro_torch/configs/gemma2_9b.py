"""gemma2-9b [dense]: 42L d3584 16H (GQA kv=8, head_dim 256) ff14336
v256000 — local(4096)/global alternating, attn softcap 50, final softcap 30,
sandwich norms, tied embeddings, sqrt(d) embed scale.  [arXiv:2408.00118; hf]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register

FULL = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    group=(LayerSpec(window=4096), LayerSpec(window=0)),
    attn_softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    tie_embeddings=True,
    embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab=512,
    group=(LayerSpec(window=16), LayerSpec(window=0)),
    attn_softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    remat=False,
)

register(FULL, SMOKE)
