"""Keystream engine registry: the consumer half of the T3 split.

Every consumer that turns (key, round constants[, noise, mats]) into
keystream is a registered engine with declared capabilities:

  * ``ref``  — the plain PyTorch schedule interpreter, on whatever device
               the engine is bound to.  The bit-exactness oracle.
  * ``cuda`` — the fused CUDA keystream kernel (csrc/keystream.cu).  Needs
               a CUDA device.

"auto" resolves by the device the caller asked for: ``cuda`` for a CUDA
device, ``ref`` for an explicit CPU — never by what happens to be
installed.  All engines are bit-exact with ``ref``.

    eng = make_engine("auto", params, key, device="cuda")
    z = eng.keystream_from_constants(rc, noise, mats)   # or eng(constants)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Type, Union

import numpy as np
import torch

from repro_torch.core.params import CipherParams
from repro_torch.core.redplan import DEFAULT_REDUCTION, REDUCTION_MODES
from repro_torch.core.schedule import VARIANTS, build_schedule
from repro_torch.device import resolve_device
from repro_torch.kernels.keystream.ops import keystream_kernel_apply
from repro_torch.kernels.keystream.ref import keystream_ref


@dataclasses.dataclass(frozen=True)
class EngineCaps:
    """What one backend can do, queried without instantiating it."""

    name: str
    description: str
    available: bool
    reason: str = ""
    device_types: Tuple[str, ...] = ("cpu", "cuda")
    schedule_variants: Tuple[str, ...] = VARIANTS
    preferred_variant: str = "normal"


def _key_tensor(key, device) -> torch.Tensor:
    if torch.is_tensor(key):
        return key.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(key, np.int64), device=device)


class KeystreamEngine:
    """One way to materialize keystream, bound to (params, key, device)."""

    name: str = "?"

    def __init__(self, params: CipherParams, key, *, device=None,
                 variant: str = "normal",
                 reduction: str = DEFAULT_REDUCTION):
        self.params = params
        self.device = resolve_device(device)
        self.caps = type(self).query_caps()
        if self.device.type not in self.caps.device_types:
            raise ValueError(
                f"engine {self.name!r} runs on {self.caps.device_types}, "
                f"not {self.device}")
        self.key = _key_tensor(key, self.device)
        if variant == "auto":
            variant = self.caps.preferred_variant
        if variant not in self.caps.schedule_variants:
            raise ValueError(
                f"engine {self.name!r} does not support schedule variant "
                f"{variant!r} (supports {self.caps.schedule_variants})"
            )
        self.variant = variant
        if reduction not in REDUCTION_MODES:
            raise ValueError(
                f"unknown reduction mode {reduction!r}; expected one of "
                f"{REDUCTION_MODES}"
            )
        self.reduction = reduction
        self.schedule = build_schedule(params, variant)

    @classmethod
    def query_caps(cls) -> EngineCaps:
        raise NotImplementedError

    def _run(self, rc, noise, mats):
        raise NotImplementedError

    def keystream_from_constants(self, rc, noise=None, mats=None):
        """rc: (lanes, n_round_constants) int64; noise: (lanes, l) | None;
        mats: (lanes, n_matrix_constants) | None.  Returns (lanes, l)
        int64 keystream on the engine's device."""
        if self.schedule.n_matrix_constants and mats is None:
            raise ValueError(
                f"schedule {self.schedule.name} streams its affine matrices "
                "— pass the producer's mats plane"
            )
        return self._run(rc, noise, mats)

    def __call__(self, constants: dict):
        return self.keystream_from_constants(
            constants["rc"], constants.get("noise"), constants.get("mats")
        )

    def __repr__(self):
        return (f"<KeystreamEngine {self.name} params={self.params.name} "
                f"device={self.device}>")


_REGISTRY: Dict[str, Type[KeystreamEngine]] = {}


def register_engine(cls: Type[KeystreamEngine]) -> Type[KeystreamEngine]:
    if cls.name in _REGISTRY:
        raise ValueError(f"engine {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls
    return cls


def registered_engines() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_engine(spec: str, device) -> str:
    """THE single place engine selection lives: "auto" is ``cuda`` on a
    CUDA device and ``ref`` on an explicit CPU device."""
    if spec == "auto":
        spec = "cuda" if torch.device(device).type == "cuda" else "ref"
    if spec not in _REGISTRY:
        raise ValueError(
            f"unknown keystream engine {spec!r}; registered engines: "
            f"{list(registered_engines())} (plus 'auto')"
        )
    return spec


EngineSpec = Union[str, KeystreamEngine]


def make_engine(spec: EngineSpec, params: CipherParams, key, *, device=None,
                variant: Optional[str] = None,
                reduction: Optional[str] = None) -> KeystreamEngine:
    """Resolve ``spec`` and bind it to (params, key, device).  An engine
    instance passes through only if it is bound to the same (params, key)
    and does not contradict an explicit variant or reduction mode."""
    if isinstance(spec, KeystreamEngine):
        if spec.params != params or not torch.equal(
                spec.key.cpu(), _key_tensor(key, "cpu")):
            raise ValueError(
                f"engine {spec.name!r} is bound to different (params, key) "
                f"(engine has {spec.params.name})")
        if variant is not None and variant != "auto" \
                and variant != spec.variant:
            raise ValueError(
                f"engine {spec.name!r} already executes the "
                f"{spec.variant!r} schedule variant; requested {variant!r}")
        if reduction is not None and reduction != spec.reduction:
            raise ValueError(
                f"engine {spec.name!r} already runs the {spec.reduction!r} "
                f"reduction schedule; requested {reduction!r}")
        return spec
    dev = resolve_device(device)
    name = resolve_engine(spec, dev)
    cls = _REGISTRY[name]
    caps = cls.query_caps()
    if not caps.available:
        raise RuntimeError(
            f"keystream engine {name!r} unavailable here: {caps.reason}")
    return cls(params, key, device=dev,
               variant=variant if variant is not None else "normal",
               reduction=reduction if reduction is not None
               else DEFAULT_REDUCTION)


@register_engine
class RefEngine(KeystreamEngine):
    """Plain PyTorch schedule interpreter — the oracle, on any device."""

    name = "ref"

    @classmethod
    def query_caps(cls) -> EngineCaps:
        return EngineCaps(
            name=cls.name,
            description="plain PyTorch interpreter (bit-exactness oracle)",
            available=True,
        )

    def _run(self, rc, noise, mats):
        return keystream_ref(self.params, self.key, rc, noise,
                             variant=self.variant, mats=mats,
                             reduction=self.reduction)


@register_engine
class CudaEngine(KeystreamEngine):
    """The fused CUDA keystream kernel."""

    name = "cuda"

    @classmethod
    def query_caps(cls) -> EngineCaps:
        ok = torch.cuda.is_available()
        return EngineCaps(
            name=cls.name,
            description="fused CUDA keystream kernel (csrc/keystream.cu)",
            available=ok,
            reason="" if ok else "no CUDA device is available",
            device_types=("cuda",),
        )

    def _run(self, rc, noise, mats):
        if noise is not None and not self.params.n_noise:
            noise = None
        return keystream_kernel_apply(
            self.params, self.key, rc, noise, variant=self.variant,
            mats=mats, reduction=self.reduction)
