"""mamba2-2.7b [ssm]: 64L d2560, attention-free (SSD), ssm_state=128,
v50280.  Runs long_500k (sub-quadratic).  [arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register

FULL = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab=50280,
    group=(LayerSpec(kind="mamba"),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    rope_kind="none",
)

SMOKE = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab=512,
    group=(LayerSpec(kind="mamba"),),
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    conv_width=4,
    ssm_chunk=32,
    rope_kind="none",
    remat=False,
)

register(FULL, SMOKE)
