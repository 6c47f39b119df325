"""granite-3-8b [dense]: 40L d4096 32H (GQA kv=8) ff12800 v49155; tied
embeddings.  [hf:ibm-granite/granite-3.0-2b-base; hf]"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    kv_heads=8,
    d_ff=12800,
    vocab=49155,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    kv_heads=2,
    d_ff=128,
    vocab=515,        # deliberately non-multiple-of-128 (tests padding)
    tie_embeddings=True,
    remat=False,
)

register(FULL, SMOKE)
