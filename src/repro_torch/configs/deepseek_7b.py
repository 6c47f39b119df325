"""deepseek-7b [dense]: 30L d4096 32H (MHA: kv=32) ff11008 v102400 —
llama-arch.  [arXiv:2401.02954; hf]"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    kv_heads=32,
    d_ff=11008,
    vocab=102400,
)

SMOKE = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    kv_heads=4,
    d_ff=128,
    vocab=512,
    remat=False,
)

register(FULL, SMOKE)
