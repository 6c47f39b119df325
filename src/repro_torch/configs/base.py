"""Model configuration system.

One `ModelConfig` describes any of the 10 assigned architectures, and the
port's own granite-4.0-h-small (dense /
MoE / SSM / hybrid / encoder-only / VLM-backbone).  Layer heterogeneity
(gemma2's local/global alternation, jamba's 1-attn-per-8 + MoE-every-2) is
expressed as a repeating *group* of `LayerSpec`s; each slot's parameters
are stacked over groups.

The port's copy of `repro.configs.base`: the same fields, derived
properties, analytic parameter counts and registry, and beside them the
port-only fields, whose defaults leave every reference architecture as
the reference has it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer slot inside the repeating group."""

    kind: str = "attn"        # "attn" | "mamba"
    window: int = 0           # sliding-window size; 0 = full attention
    moe: bool = False         # MoE FFN instead of dense FFN


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int            # 0 for attn-free archs
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 => d_model // num_heads

    # attention
    rope_theta: float = 1e4
    rope_kind: str = "std"    # "std" | "mrope" | "none"
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    causal: bool = True       # False = encoder-only (hubert)

    # layer group structure
    group: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # moe
    num_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25

    # ssm (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256

    # ffn
    mlp_gated: bool = True         # SwiGLU (False: plain GELU, hubert)

    # norms / embeddings
    norm_eps: float = 1e-5
    sandwich_norm: bool = False    # gemma2 pre+post block norms
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma: scale embeddings by sqrt(d)

    # modality frontend stub (audio frames / vision patches)
    frontend: str = "none"         # "none" | "audio" | "vision"
    frontend_dim: int = 0          # stub embedding dim fed by input_specs()

    # port-only fields (the reference has none of them; each default
    # leaves every reference architecture as it is): granite-4.0-h's
    # muP multipliers, shared expert, conv bias and dropless expert share
    shared_d_ff: int = 0           # a shared SwiGLU expert beside the routed
    embed_mult: float = 1.0        # embeddings x this
    residual_mult: float = 1.0     # each branch x this before its residual add
    logits_div: float = 1.0        # logits / this
    attn_scale: float = 0.0        # softmax scale; 0 = 1/sqrt(head_dim)
    conv_bias: bool = False        # Mamba2 conv bias on x, B, C
    dropless: bool = False         # every routed assignment is computed
    experts_held: int = 0          # experts this device holds; 0 = all
    expert_rank: int = 0           # held = [rank*held, (rank+1)*held)

    # numerics
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"   # master params ("bfloat16" for >=398B)
    opt_8bit: bool = False         # 8-bit Adam moments (arctic/jamba)
    remat: bool = True
    # roofline probes: unroll inner lax.scans (attention KV loop, SSD
    # chunks, FFN chunks) so XLA cost_analysis counts every iteration —
    # while-loop bodies are otherwise counted ONCE (launch/roofline.py)
    probe_unroll: bool = False

    # ----- derived -------------------------------------------------------
    def __post_init__(self):
        if self.num_layers % len(self.group) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"group size {len(self.group)}"
            )
        if self.num_heads and self.kv_heads:
            hd = self.head_dim or self.d_model // self.num_heads
            if self.num_heads % self.kv_heads:
                raise ValueError("num_heads must be divisible by kv_heads")
        if self.experts_held:
            if self.num_experts % self.experts_held:
                raise ValueError(f"{self.name}: {self.experts_held} held "
                                 f"experts do not divide {self.num_experts}")
            if not self.dropless:
                raise ValueError(f"{self.name}: an expert share needs "
                                 "dropless routing")
            if not 0 <= self.expert_rank < self.num_experts // self.experts_held:
                raise ValueError(
                    f"{self.name}: expert rank {self.expert_rank} outside "
                    f"{self.num_experts} experts by {self.experts_held}")

    @property
    def resolved_head_dim(self) -> int:
        if self.num_heads == 0:
            return 0
        return self.head_dim or self.d_model // self.num_heads

    @property
    def held_experts(self) -> Tuple[int, int]:
        """(first, count) of the experts this device holds."""
        n = self.experts_held or self.num_experts
        return self.expert_rank * n, n

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.group)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 128 for clean 16-way TP sharding."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        # mamba2 conv runs over [x, B, C] channels (ngroups=1)
        return self.d_inner + 2 * self.ssm_state

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS and memory budgets)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        hd = self.resolved_head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        if self.frontend != "none":
            total += self.frontend_dim * d
        total += d  # final norm
        for spec in self.group:
            n = self.num_groups
            if spec.kind == "attn":
                attn = d * self.num_heads * hd + 2 * d * self.kv_heads * hd \
                    + self.num_heads * hd * d
                total += n * attn
            else:
                di, st = self.d_inner, self.ssm_state
                h = self.ssm_heads
                total += n * (
                    d * (2 * di + 2 * st + h)   # in_proj (x, z, B, C, dt)
                    + self.conv_width * self.conv_dim
                    + 2 * h                      # A_log, D
                    + di * d                     # out_proj
                    + self.conv_dim * self.conv_bias
                )
            mats = 3 if self.mlp_gated else 2
            if spec.moe:
                held = self.held_experts[1]
                total += n * (held * 3 * d * f + d * self.num_experts)
                total += n * 3 * d * self.shared_d_ff
                if self.dense_residual:
                    total += n * mats * d * f
            elif f > 0:
                total += n * mats * d * f
            total += n * 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k of num_experts; of a share,
        its experts' expected part of the top_k)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        E, held = self.num_experts, self.held_experts[1]
        inactive = 0
        for spec in self.group:
            if spec.moe:
                inactive += (self.num_groups * held * (E - self.top_k)
                             * 3 * d * f // E)
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg_full: ModelConfig, cfg_smoke: ModelConfig):
    _REGISTRY[cfg_full.name] = (cfg_full, cfg_smoke)
    return cfg_full


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name][1 if smoke else 0]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    # import for side effect of register() calls
    from repro_torch.configs import (  # noqa: F401
        internlm2_20b, granite_3_8b, deepseek_7b, gemma2_9b, qwen2_vl_7b,
        hubert_xlarge, mamba2_2_7b, mixtral_8x7b, arctic_480b,
        jamba_1_5_large, granite_4_0_h_small,
    )
