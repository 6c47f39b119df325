"""internlm2-20b [dense]: 48L d6144 48H (GQA kv=8) ff16384 v92544.
[arXiv:2403.17297; hf]"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    kv_heads=8,
    d_ff=16384,
    vocab=92544,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    kv_heads=2,
    d_ff=128,
    vocab=512,
    rope_theta=1e6,
    remat=False,
)

register(FULL, SMOKE)
