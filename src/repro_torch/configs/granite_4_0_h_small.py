"""granite-4.0-h-small (32B-A9B) [hybrid, port only]: 40L d4096; each
layer a mixer then an MoE block.  Mixers: Mamba-2 in 36 layers (128 heads
x 64, d_state 128, n_groups 1, conv 4 with a bias, chunk 256) and GQA
attention in 4 (32 query heads, 8 KV heads of 128, NoPE, softmax scale
``attention_multiplier`` 1/128), at layers 5, 15, 25 and 35.  MoE: 72
routed SwiGLU experts of width 768, top-10, dropless, beside a shared
SwiGLU expert of width 1536.  muP: embeddings x 12, each branch x 0.22
before its residual add, logits / 16.  Vocabulary 100352, tied.
[hf:ibm-granite/granite-4.0-h-small config.json]

The layer pattern is a period of 10 (attention at slot 5), four groups.
``experts_held`` and ``expert_rank`` give one device's share of an
expert-parallel deployment (``dataclasses.replace``); the registry's
FULL holds every expert."""

from repro_torch.configs.base import LayerSpec, ModelConfig, register


def _group():
    return tuple(LayerSpec(kind="attn" if i == 5 else "mamba", moe=True)
                 for i in range(10))


FULL = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab=100352,
    rope_kind="none",
    group=_group(),
    num_experts=72,
    top_k=10,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
    shared_d_ff=1536,
    embed_mult=12.0,
    residual_mult=0.22,
    logits_div=16.0,
    attn_scale=0.0078125,
    conv_bias=True,
    dropless=True,
)

SMOKE = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=10,
    d_model=64,
    num_heads=4,
    kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab=512,        # a multiple of 128: no padded rows in the softmax
    rope_kind="none",
    group=_group(),
    num_experts=8,
    top_k=3,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    conv_width=4,
    ssm_chunk=16,
    tie_embeddings=True,
    shared_d_ff=48,
    embed_mult=12.0,
    residual_mult=0.22,
    logits_div=16.0,
    attn_scale=0.0625,
    conv_bias=True,
    dropless=True,
    remat=False,
)

register(FULL, SMOKE)
