"""Round-schedule IR: the cipher as a declarative program.

The port's own copy of the framework-free IR of `repro.core.schedule`:
the op dataclasses (:class:`ARK`, :class:`MRMC`, :class:`NONLINEAR`,
:class:`TRUNCATE`, :class:`AGN`), :func:`build_schedule` emitting the HERA,
Rubato and PASTA programs in a ``normal`` and an ``alternating``
orientation variant, the storage-order layout helpers, and
:func:`execute_schedule`, the plain PyTorch interpreter every engine and
the fused CUDA kernel are held against.  Listings (`Schedule.describe`)
match the reference character for character.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rounds as R
from repro_torch.core.rounds import ic_vector

if TYPE_CHECKING:  # params imports us lazily (accounting properties)
    from repro_torch.core.params import CipherParams

NORMAL = "normal"
TRANSPOSED = "transposed"
ORIENTATIONS = (NORMAL, TRANSPOSED)

#: Schedule variants build_schedule understands.
VARIANTS = ("normal", "alternating")


def _flip(orientation: str) -> str:
    return TRANSPOSED if orientation == NORMAL else NORMAL


def transpose_perm(v: int) -> np.ndarray:
    """The state-transposition permutation on flat row-major indices.

    ``perm[c*v + r] = r*v + c`` — the stored element at flat position i of a
    transposed state is the logical element ``perm[i]``.  An involution, so
    the same array maps stored->logical and logical->stored.
    """
    return np.arange(v * v).reshape(v, v).T.reshape(-1)


def state_transpose_perm(v: int, branches: int = 1) -> np.ndarray:
    """Transposition permutation for the FULL flat state.

    Each branch's (v, v) view transposes independently — branches never
    interleave — so the permutation is :func:`transpose_perm` blocked per
    branch.  With one branch this is plain ``transpose_perm(v)``.  Still an
    involution.
    """
    tp = transpose_perm(v)
    t = v * v
    return np.concatenate([tp + b * t for b in range(branches)])


def dense_mat_perm(v: int, in_orientation: str,
                   out_orientation: str) -> np.ndarray:
    """Storage-order re-index of one branch's flattened t×t stream matrix.

    A stream-sourced affine layer applies a *logical* dense matrix
    y[i] = Σ_j M[i, j]·x[j] per branch.  When the chain stores the input
    state permuted by p_in and must deliver the output permuted by p_out
    (the transpose permutation per orientation), the stored-state compute
    is y_s[i] = Σ_j M[p_out[i], p_in[j]]·x_s[j] — i.e. the matrix itself
    is re-indexed, rows by p_out and columns by p_in, and the datapath
    never gathers.  Returns p with ``mat_storage = mat_logical[p]`` over
    the branch's flat row-major t² words (identity when both normal).
    """
    t = v * v
    ident = np.arange(t)
    p_in = transpose_perm(v) if in_orientation == TRANSPOSED else ident
    p_out = transpose_perm(v) if out_orientation == TRANSPOSED else ident
    return (p_out[:, None] * t + p_in[None, :]).reshape(-1)


# ==========================================================================
# Ops
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class Op:
    """Base: every op carries the orientation its input state is stored in."""

    orientation: str = NORMAL


@dataclasses.dataclass(frozen=True)
class ARK(Op):
    """Add-round-key x + k ⊙ rc, with the randomized key schedule.

    ``rc_slice`` is the [start, stop) window of the flat logical
    round-constant stream this op consumes — the paper's RNG-FIFO
    accounting: the producer must have delivered exactly ``stop`` constants
    before this op fires.  ``key_len`` is n except for Rubato's final
    truncated ARK (l: the trailing n−l constants are dead).
    """

    rc_slice: Tuple[int, int] = (0, 0)
    key_len: int = 0


@dataclasses.dataclass(frozen=True)
class MRMC(Op):
    """Fused MixRows∘MixColumns M_v·X·M_vᵀ, applied per branch.

    ``out_orientation`` may differ from ``orientation``: by Eq. 2
    (MRMC(Xᵀ) = MRMC(X)ᵀ) the stored-state computation is *identical* in
    both orientations, and a flip is a free relabeling of the output
    stacking — this is what lets the alternating variant hand each round
    the state in the orientation the previous round left it.

    The PASTA generalization: ``rc_slice`` (non-empty) turns the op into
    the cipher's affine layer — the matrix output gets per-branch round
    constants **added** (consumed in ``out_orientation``, unlike ARK's
    key-multiplied constants consumed in ``orientation``), and
    ``mix_branches`` then applies the (2·y_L + y_R, y_L + 2·y_R) branch
    coupling.  HERA/Rubato programs leave both at their defaults.

    ``matrix_source`` selects where the matrix comes from: ``"static"``
    (the fixed circulant M_v — HERA/Rubato, and the pre-stream PASTA
    stand-in) or ``"stream"`` — the published PASTA affine layer, a fresh
    per-(nonce, counter) dense t×t matrix per branch drawn from the same
    decoupled XOF stream as the constants.  ``mat_slice`` is then the
    [start, stop) window of the flat logical matrix-plane word stream this
    op consumes (branches·t² words: branch 0's t×t row-major, then branch
    1's), the matrix-plane analogue of the rc FIFO accounting.
    """

    out_orientation: str = NORMAL
    rc_slice: Tuple[int, int] = (0, 0)
    mix_branches: bool = False
    matrix_source: str = "static"
    mat_slice: Tuple[int, int] = (0, 0)

    @property
    def has_rc(self) -> bool:
        return self.rc_slice[1] > self.rc_slice[0]

    @property
    def streams_matrix(self) -> bool:
        return self.matrix_source == "stream"


@dataclasses.dataclass(frozen=True)
class NONLINEAR(Op):
    """Elementwise cipher nonlinearity: ``cube`` (HERA, PASTA's final
    round) or ``feistel`` (Rubato, PASTA's intermediate rounds) — applied
    per branch (PASTA's Feistel chain restarts at the branch boundary).

    Cube is orientation-agnostic; Feistel couples flat-index neighbors, so
    in transposed orientation the neighbor pattern becomes a static
    row/column shift of the (v, v) view (no data transpose).
    """

    kind: str = "cube"


@dataclasses.dataclass(frozen=True)
class TRUNCATE(Op):
    """Tr_{n,l}: keep the first ``keep`` logical elements (normal-only)."""

    keep: int = 0


@dataclasses.dataclass(frozen=True)
class AGN(Op):
    """Add the cipher's own discrete-Gaussian noise (Rubato; client-side).

    Executors apply it only when noise is supplied — the op records that
    the *program* ends with an AGN stage, not that every run draws noise.
    """


@dataclasses.dataclass(frozen=True)
class OpInfo:
    """Static per-op facts from one walk of the program.

    The shared substrate for the `analysis` passes: each entry
    records the state the *chain* is actually in when the op fires
    (``chain_orientation`` — propagated through MRMC flips, which is what
    the op's own ``orientation`` annotation must match) plus the state
    width flowing in and out (TRUNCATE shrinks it).  ``provenance`` is the
    human-readable site string analyzers attach to findings.
    """

    index: int
    op: Op
    in_width: int
    out_width: int
    chain_orientation: str   # orientation the chain delivers to this op
    out_orientation: str     # orientation the chain is in after this op
    provenance: str          # "hera-128a/alternating ops[3] NONLINEAR(cube)"


def _op_label(op: Op) -> str:
    if isinstance(op, NONLINEAR):
        return f"NONLINEAR({op.kind})"
    if isinstance(op, MRMC) and op.has_rc:
        return "MRMC(affine)"
    return type(op).__name__


# ==========================================================================
# Schedule
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class Schedule:
    """One cipher program: ops plus the static facts executors need."""

    name: str          # e.g. "hera-128a/alternating"
    kind: str          # "hera" | "rubato" | "pasta"
    variant: str       # "normal" | "alternating"
    n: int
    l: int
    v: int
    ops: Tuple[Op, ...]
    branches: int = 1  # PASTA: 2 independent (v, v) branch matrices
    init: str = "ic"   # initial state: "ic" (public constant) | "key"
    #: lint rule codes suppressed for this program (the
    #: `# noqa`-style escape hatch; docs/DESIGN.md §13 on when it is OK)
    suppress: Tuple[str, ...] = ()

    # ---- derived accounting (the single source of truth) -----------------
    @property
    def n_arks(self) -> int:
        return sum(isinstance(op, ARK) for op in self.ops)

    @property
    def n_round_constants(self) -> int:
        return max(op.rc_slice[1] for op in self.ops
                   if isinstance(op, (ARK, MRMC)) and op.rc_slice[1])

    @property
    def n_matrix_constants(self) -> int:
        """Total matrix-plane words per stream key — the matrix FIFO depth.

        0 for static-matrix programs (HERA/Rubato); PASTA's stream-sourced
        affine layers draw (r+1)·branches·t² words ((r+1)·n·t).
        """
        return max((op.mat_slice[1] for op in self.ops
                    if isinstance(op, MRMC) and op.streams_matrix),
                   default=0)

    @property
    def n_mrmc(self) -> int:
        return sum(isinstance(op, MRMC) for op in self.ops)

    @property
    def has_transposed_ops(self) -> bool:
        return any(op.orientation == TRANSPOSED for op in self.ops)

    # ---- layout helpers --------------------------------------------------
    def rc_storage_perm(self) -> Optional[np.ndarray]:
        """Logical→storage constant reorder for lane-major kernels.

        Returns a permutation p with ``rc_storage = rc_logical[p]`` such
        that every constant-consuming op reads a *contiguous* slice already
        matching its orientation — the RNG FIFO delivers constants in
        exactly the order the datapath consumes them, so a transposed-
        orientation ARK (or PASTA affine layer) costs no in-kernel gather.
        ARK constants are consumed in the op's input orientation; an
        affine MRMC adds its constants AFTER the matrix, i.e. in
        ``out_orientation``.  None when no reorder is needed.
        """
        perm = np.arange(self.n_round_constants)
        tp = state_transpose_perm(self.v, self.branches)
        changed = False
        for op in self.ops:
            if isinstance(op, ARK) and op.orientation == TRANSPOSED:
                a, b = op.rc_slice
                perm[a:b] = a + tp[: b - a]
                changed = True
            elif (isinstance(op, MRMC) and op.has_rc
                  and op.out_orientation == TRANSPOSED):
                a, b = op.rc_slice
                perm[a:b] = a + tp[: b - a]
                changed = True
        return perm if changed else None

    def mat_storage_perm(self) -> Optional[np.ndarray]:
        """Logical→storage matrix-plane reorder — `rc_storage_perm`'s
        matrix analogue, extending the storage-order constant FIFO to the
        dense planes.

        Each stream-sourced op's branch-local t² block is re-indexed by
        :func:`dense_mat_perm` (rows by the op's output orientation,
        columns by its input orientation) so the lane-major kernel's
        dense matvec consumes matrix words in exactly the stored-state
        order — no in-kernel gather, and never across a branch boundary.
        None when no reorder is needed (normal-variant programs, and any
        program with no stream matrices).
        """
        n_mat = self.n_matrix_constants
        if not n_mat:
            return None
        perm = np.arange(n_mat)
        t = self.v * self.v
        changed = False
        for op in self.ops:
            if not (isinstance(op, MRMC) and op.streams_matrix):
                continue
            if op.orientation == NORMAL and op.out_orientation == NORMAL:
                continue
            block = dense_mat_perm(self.v, op.orientation,
                                   op.out_orientation)
            a, _ = op.mat_slice
            for br in range(self.branches):
                base = a + br * t * t
                perm[base:base + t * t] = base + block
            changed = True
        return perm if changed else None

    # ---- analysis substrate ---------------------------------------------
    def op_table(self) -> Tuple[OpInfo, ...]:
        """One walk of the program -> per-op static facts (:class:`OpInfo`).

        Never raises on malformed programs — the linter
        (`analysis.lint`) diagnoses those, and it needs the walk to
        keep going past the first inconsistency: the chain orientation is
        propagated through MRMC ``out_orientation`` regardless of whether
        the op's own annotation matched, and TRUNCATE narrows the width
        even when ``keep`` is nonsensical (clamped at >= 0).
        """
        rows = []
        cur = NORMAL
        width = self.n
        for i, op in enumerate(self.ops):
            out_w = width
            out_o = cur
            if isinstance(op, MRMC):
                out_o = op.out_orientation
            elif isinstance(op, TRUNCATE):
                out_w = max(0, min(width, op.keep))
            rows.append(OpInfo(
                index=i, op=op, in_width=width, out_width=out_w,
                chain_orientation=cur, out_orientation=out_o,
                provenance=f"{self.name} ops[{i}] {_op_label(op)}",
            ))
            cur, width = out_o, out_w
        return tuple(rows)

    # ---- validation ------------------------------------------------------
    def validate(self) -> "Schedule":
        """Check orientation continuity and round-constant coverage."""
        cur = NORMAL
        next_rc = 0
        next_mat = 0
        width = self.n
        for i, op in enumerate(self.ops):
            if op.orientation != cur:
                raise ValueError(
                    f"{self.name}: op {i} ({type(op).__name__}) expects "
                    f"{op.orientation} state but the schedule is {cur} here"
                )
            if isinstance(op, ARK):
                a, b = op.rc_slice
                if a != next_rc or b - a != op.key_len or op.key_len != width:
                    raise ValueError(
                        f"{self.name}: ARK {i} rc_slice {op.rc_slice} / "
                        f"key_len {op.key_len} inconsistent (state width "
                        f"{width}, next constant {next_rc})"
                    )
                next_rc = b
            elif isinstance(op, MRMC):
                if op.has_rc:
                    a, b = op.rc_slice
                    if a != next_rc or b - a != width:
                        raise ValueError(
                            f"{self.name}: affine MRMC {i} rc_slice "
                            f"{op.rc_slice} inconsistent (state width "
                            f"{width}, next constant {next_rc})"
                        )
                    next_rc = b
                if op.mix_branches and self.branches != 2:
                    raise ValueError(
                        f"{self.name}: MRMC {i} mixes branches but the "
                        f"schedule has {self.branches}"
                    )
                if op.matrix_source not in ("static", "stream"):
                    raise ValueError(
                        f"{self.name}: MRMC {i} unknown matrix_source "
                        f"{op.matrix_source!r}"
                    )
                if op.streams_matrix:
                    a, b = op.mat_slice
                    want = width * (width // self.branches)  # branches·t²
                    if a != next_mat or b - a != want:
                        raise ValueError(
                            f"{self.name}: stream MRMC {i} mat_slice "
                            f"{op.mat_slice} inconsistent (need {want} "
                            f"words, next matrix word {next_mat})"
                        )
                    next_mat = b
                elif op.mat_slice != (0, 0):
                    raise ValueError(
                        f"{self.name}: static MRMC {i} carries mat_slice "
                        f"{op.mat_slice}"
                    )
                cur = op.out_orientation
            elif isinstance(op, TRUNCATE):
                if cur != NORMAL:
                    raise ValueError(
                        f"{self.name}: TRUNCATE needs normal orientation"
                    )
                width = op.keep
            elif isinstance(op, AGN) and cur != NORMAL:
                raise ValueError(f"{self.name}: AGN needs normal orientation")
        if cur != NORMAL:
            raise ValueError(f"{self.name}: program must end normal")
        if next_rc != self.n_round_constants:
            raise ValueError(f"{self.name}: round constants not contiguous")
        if next_mat != self.n_matrix_constants:
            raise ValueError(f"{self.name}: matrix planes not contiguous")
        if self.init not in ("ic", "key"):
            raise ValueError(f"{self.name}: unknown init {self.init!r}")
        return self

    def describe(self) -> str:
        """Human-readable program listing (docs/DESIGN.md §9/§11 format)."""
        head = (f"schedule {self.name}  (n={self.n}, l={self.l}, "
                f"{self.n_arks} ARKs, {self.n_round_constants} constants")
        if self.n_matrix_constants:
            head += f", {self.n_matrix_constants} matrix words"
        if self.branches > 1:
            head += f", {self.branches} branches, init={self.init}"
        rows = [head + ")"]
        for i, op in enumerate(self.ops):
            o = "T" if op.orientation == TRANSPOSED else "N"
            if isinstance(op, ARK):
                a, b = op.rc_slice
                rows.append(f"  {i:2d}  ARK[{o}]      rc[{a}:{b}]  "
                            f"key[:{op.key_len}]")
            elif isinstance(op, MRMC):
                oo = "T" if op.out_orientation == TRANSPOSED else "N"
                extra = ""
                if op.streams_matrix:
                    extra += f"  mat[{op.mat_slice[0]}:{op.mat_slice[1]}]"
                if op.has_rc:
                    extra += f"  +rc[{op.rc_slice[0]}:{op.rc_slice[1]}]"
                if op.mix_branches:
                    extra += "  mix"
                rows.append(f"  {i:2d}  MRMC[{o}->{oo}]{extra}")
            elif isinstance(op, NONLINEAR):
                rows.append(f"  {i:2d}  {op.kind.upper()}[{o}]")
            elif isinstance(op, TRUNCATE):
                rows.append(f"  {i:2d}  TRUNCATE[{o}] keep {op.keep}")
            elif isinstance(op, AGN):
                rows.append(f"  {i:2d}  AGN[{o}]")
        return "\n".join(rows)


# ==========================================================================
# Builder
# ==========================================================================
@functools.lru_cache(maxsize=None)
def build_schedule(params: "CipherParams", variant: str = "normal") -> Schedule:
    """Emit the cipher program for ``params`` — the ONE place the HERA,
    Rubato, and PASTA round structures are written down.

    HERA and Rubato share the skeleton (paper §III):

        ARK ∘ [MRMC ∘ NL ∘ ARK]^{r-1} ∘ MRMC ∘ NL ∘ MRMC ∘ [Tr] ∘ ARK ∘ [AGN]

    differing only in the nonlinearity (Cube vs Feistel), truncation
    (Rubato: l < n makes the final ARK's trailing constants dead) and AGN.

    PASTA applies its two-branch permutation to the KEY (init="key") with
    per-block randomness entering through additive affine constants:

        Tr_t ∘ A_r ∘ Cube ∘ [A_i ∘ Feistel]... reading right-to-left:
        [A_i ∘ S_i]^r ∘ A_r where A = per-branch MRMC + rc + branch mix,
        S_i = Feistel for i < r-1 and Cube for the final round,

    i.e. r+1 affine layers consuming (r+1)·n constants — the same MRMC
    count as the shared skeleton, so the alternating variant's flip plan
    carries over unchanged (docs/DESIGN.md §11 documents the stand-ins).

    ``variant="alternating"`` flips MRMC orientation per application; when
    the MRMC count is odd the last one stays put so TRUNCATE/output see
    normal orientation.  Cached per (params, variant) — CipherParams is
    frozen/hashable — so accounting properties can call this freely.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown schedule variant {variant!r}; "
                         f"have {VARIANTS}")
    n, l, r, v = params.n, params.l, params.rounds, params.v
    n_mrmc = r + 1
    # flip at every MRMC; with an odd count the last one keeps orientation
    # so truncation and the output stage always see normal state
    flips = (n_mrmc - (n_mrmc % 2)) if variant == "alternating" else 0

    ops = []
    cur = NORMAL
    mrmc_seen = 0

    def mrmc(**kw):
        nonlocal cur, mrmc_seen
        out = _flip(cur) if mrmc_seen < flips else cur
        ops.append(MRMC(orientation=cur, out_orientation=out, **kw))
        cur = out
        mrmc_seen += 1

    if params.kind == "pasta":
        # [A_i ∘ S_i]^r ∘ A_r on the key state; constants consumed by the
        # affine layers in out-orientation, mix coupling the two branches.
        # Each affine layer applies a fresh per-block dense t×t matrix per
        # branch, streamed from the producer (n·t matrix words per layer).
        t = n // params.branches
        for j in range(r):
            mrmc(rc_slice=(j * n, (j + 1) * n), mix_branches=True,
                 matrix_source="stream",
                 mat_slice=(j * n * t, (j + 1) * n * t))
            ops.append(NONLINEAR(
                orientation=cur, kind="feistel" if j < r - 1 else "cube"))
        mrmc(rc_slice=(r * n, (r + 1) * n), mix_branches=True,
             matrix_source="stream",
             mat_slice=(r * n * t, (r + 1) * n * t))
        ops.append(TRUNCATE(orientation=cur, keep=l))
        return Schedule(
            name=f"{params.name}/{variant}", kind=params.kind,
            variant=variant, n=n, l=l, v=v, ops=tuple(ops),
            branches=params.branches, init="key",
        ).validate()

    nl = "cube" if params.kind == "hera" else "feistel"
    ops.append(ARK(orientation=cur, rc_slice=(0, n), key_len=n))
    for j in range(1, r):                          # RF_1 .. RF_{r-1}
        mrmc()
        ops.append(NONLINEAR(orientation=cur, kind=nl))
        ops.append(ARK(orientation=cur, rc_slice=(j * n, (j + 1) * n),
                       key_len=n))
    # Fin
    mrmc()
    ops.append(NONLINEAR(orientation=cur, kind=nl))
    mrmc()
    if l < n:
        ops.append(TRUNCATE(orientation=cur, keep=l))
    ops.append(ARK(orientation=cur, rc_slice=(r * n, r * n + l), key_len=l))
    if params.kind == "rubato" and params.sigma > 0:
        ops.append(AGN(orientation=cur))

    return Schedule(
        name=f"{params.name}/{variant}", kind=params.kind, variant=variant,
        n=n, l=l, v=v, ops=tuple(ops),
    ).validate()


# ==========================================================================
# Plain PyTorch interpreter (the oracle every engine and kernel matches)
# ==========================================================================
def _swap_last(x, params: "CipherParams"):
    """Transpose each branch's (v, v) view of a flat (..., n) state."""
    v, b = params.v, params.branches
    X = x.reshape(x.shape[:-1] + (b, v, v))
    return X.transpose(-1, -2).reshape(x.shape)


def _mrmc_flat(params: "CipherParams", x, flip_out: bool,
               in_bound: int | None = None, lazy: bool = False):
    """M_v·X·M_vᵀ per branch on flat (..., n) state; flip_out transposes
    the output (Eq. 2: the stored-state compute is orientation-free)."""
    out = R.mrmc(params, x, in_bound=in_bound, lazy=lazy)
    return _swap_last(out, params) if flip_out else out


def _feistel_transposed(params: "CipherParams", x):
    """Feistel on transposed-stored state: stored (c, r) holds logical
    r·v + c, so the logical predecessor sits one row up, wrapping to
    (v-1, r-1) at the row boundary.  Branches restart the chain."""
    mod, v, b = params.mod, params.v, params.branches
    S = x.reshape(x.shape[:-1] + (b, v, v))       # axes (..., b, c, r)
    sq = mod.square(S)
    row0 = torch.cat(
        [torch.zeros_like(sq[..., :1, :1]), sq[..., v - 1:, : v - 1]], dim=-1
    )
    shifted = torch.cat([row0, sq[..., : v - 1, :]], dim=-2)
    return mod.add(S, shifted).reshape(x.shape)


def execute_schedule(params: "CipherParams", schedule: Schedule, key, rc,
                     noise_signed=None, ic=None, mats=None,
                     reduction: str = "lazy", plan=None):
    """Interpret ``schedule`` in plain PyTorch on int64 tensors.

    key: (..., n) int64 in Z_q; rc: (..., n_round_constants) int64 in
    *logical* (producer) order; noise_signed: (..., l) signed ints or None;
    mats: (..., n_matrix_constants) int64 in logical order (required iff
    the program streams matrices).  Returns (..., l) int64 keystream on
    rc's device.  ``reduction``/``plan`` select where the reductions fire
    (`core.redplan`); the canonical output is the same either way.
    Transposed ops index key/rc/matrix words through the transpose
    permutation; MRMC flips are output relabelings.
    """
    if rc.shape[-1] != schedule.n_round_constants:
        raise ValueError(
            f"rc last dim {rc.shape[-1]} != {schedule.n_round_constants} "
            f"(schedule {schedule.name})"
        )
    n_mat = schedule.n_matrix_constants
    if n_mat and (mats is None or mats.shape[-1] != n_mat):
        got = "None" if mats is None else mats.shape[-1]
        raise ValueError(
            f"mats last dim {got} != {n_mat} (schedule {schedule.name} "
            "streams its affine matrices)"
        )
    from repro_torch.core import redplan as RP

    if plan is None:
        plan = RP.plan_reductions(params, schedule, reduction)
    plan.validate(schedule)

    dev = rc.device
    key = key.to(dev)
    if schedule.init == "key":
        x = key.expand(rc.shape[:-1] + (params.n,))
    else:
        if ic is None:
            ic = torch.as_tensor(ic_vector(params).astype(np.int64),
                                 device=dev)
        x = ic.expand(rc.shape[:-1] + (params.n,))
    tp = torch.as_tensor(state_transpose_perm(schedule.v, schedule.branches),
                         device=dev)

    for i, op in enumerate(schedule.ops):
        p_i = plan.ops[i]
        if isinstance(op, ARK):
            a, b = op.rc_slice
            rcs = rc[..., a:b]
            k = key[..., : op.key_len]
            if op.orientation == TRANSPOSED:
                rcs, k = rcs[..., tp], key[..., tp]
            x = R.ark(params, x, k, rcs,
                      reduce_out=not p_i.has(RP.DEFER_OUT))
        elif isinstance(op, MRMC):
            if op.streams_matrix:
                a, b = op.mat_slice
                m = mats[..., a:b]
                perm = dense_mat_perm(schedule.v, op.orientation,
                                      op.out_orientation)
                if not np.array_equal(perm, np.arange(len(perm))):
                    nb, tt = schedule.branches, len(perm)
                    idx = np.concatenate([perm + br * tt
                                          for br in range(nb)])
                    m = m[..., torch.as_tensor(idx, device=dev)]
                t = schedule.v * schedule.v
                M = m.reshape(m.shape[:-1] + (schedule.branches, t, t))
                X = x.reshape(x.shape[:-1] + (schedule.branches, t))
                if p_i.has(RP.LAZY_DENSE):
                    y = params.mod.matvec_dense(M, X, x_bound=p_i.in_bound,
                                                lazy=True)
                else:
                    y = params.mod.matvec_dense(M, X)
                x = y.reshape(x.shape)
            else:
                x = _mrmc_flat(params, x,
                               op.orientation != op.out_orientation,
                               in_bound=p_i.in_bound,
                               lazy=p_i.has(RP.LAZY_ACCUMULATE))
            fold = p_i.has(RP.FOLD_MIX)
            if op.has_rc:
                a, b = op.rc_slice
                rcs = rc[..., a:b]
                if op.out_orientation == TRANSPOSED:
                    rcs = rcs[..., tp]
                # fold-mix: the raw sum (< 2q) defers into the mix reduce
                x = x + rcs if fold else params.mod.add(x, rcs)
            if op.mix_branches:
                mix_in = params.mod.q * (2 if op.has_rc else 1)
                x = R.branch_mix(params, x, in_bound=mix_in, lazy=fold)
        elif isinstance(op, NONLINEAR):
            if op.kind == "cube":
                x = R.cube(params, x)            # orientation-agnostic
            elif op.orientation == TRANSPOSED:
                x = _feistel_transposed(params, x)
            else:
                x = R.feistel(params, x)
        elif isinstance(op, TRUNCATE):
            x = x[..., : op.keep]
        elif isinstance(op, AGN):
            if noise_signed is not None and params.sigma > 0:
                x = R.agn(params, x, noise_signed.to(dev))
    return x
