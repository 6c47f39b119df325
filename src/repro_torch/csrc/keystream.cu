// Fused keystream kernel: the whole HERA / Rubato / PASTA program per lane.
//
// Replaces the Pallas kernel `_keystream_kernel`
// (repro/kernels/keystream/keystream.py, launched by `keystream_pallas`),
// which unrolls the schedule at trace time over (n, 128-lane) VMEM blocks.
//
// Design.
//  * One thread per keystream lane; ragged lane counts are masked here, not
//    padded.  No code generation: one kernel per state size N (16, 32, 36,
//    64, 128) interprets a flat int32 op table that the host builds from the
//    port's Schedule and ReductionPlan (kernels/keystream/ops.py), so every
//    preset, variant and reduction mode runs through the same binary.
//  * The state lives in dynamic shared memory laid out [word][thread]
//    (consecutive threads on consecutive banks); each op loads the words it
//    needs into registers, computes, and stores back, so every op may run in
//    place.  pasta-128l's 128 words would not stay in registers across a
//    runtime op loop.
//  * Constants arrive lane-major, (words, lanes), in the producer's logical
//    order.  The reference pre-permutes rc and matrix words into storage
//    order on the host (rc_storage_perm, mat_storage_perm) and carries a
//    second, permuted key column; here the same permutations are applied to
//    the word index inside the kernel.  They are uniform across lanes, so a
//    warp still reads one contiguous row segment per word: the loads stay
//    coalesced and the host needs no gather copy.
//  * Arithmetic: 64-bit products, uint64 accumulators, Barrett reduction to
//    [0, q) at each op's output (mrmc.cuh).  The plan's flags still choose
//    the datapath (deferred ARK output, lazy accumulation, lazy dense
//    products, folded branch mix) and both modes give the same words.
//
// Bound: bytes for PASTA (each lane reads (r+1)·n·t matrix words, 4 B each,
// once), operations for HERA and Rubato (a few hundred modmuls per lane
// against 4·(rc + l) bytes).  At serving width (4096 lanes) one thread per
// lane fills only ~1 warp per SM, so this first version is latency-bound;
// splitting a lane's rows over several threads is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "mrmc.cuh"

namespace {

using repro::ModQ;
using repro::mod_add;
using repro::mod_mul;
using repro::mod_reduce;

// Op table: 8 int32 per op (kernels/keystream/ops.py writes the same
// constants).
constexpr int kRec = 8;
enum OpKind { OP_ARK = 0, OP_MRMC = 1, OP_NONLINEAR = 2, OP_TRUNCATE = 3,
              OP_AGN = 4 };
enum OpFlag {
  F_T_IN = 1,         // op input is stored transposed
  F_T_OUT = 2,        // MRMC output is stored transposed
  F_HAS_RC = 4,       // affine MRMC: additive constants after the matrix
  F_MIX = 8,          // PASTA branch mix after the matrix
  F_STREAM = 16,      // dense matrix from the matrix plane
  F_FEISTEL = 32,     // NONLINEAR is Feistel (else cube)
  F_DEFER_OUT = 64,   // ARK leaves x + k·rc unreduced (< 2q)
  F_LAZY_ACC = 128,   // static MRMC: one reduce per row
  F_LAZY_DENSE = 256, // dense MRMC: raw products
  F_FOLD_MIX = 512,   // rc add + branch mix with one terminal reduce
};
// record fields
enum { R_KIND = 0, R_FLAGS = 1, R_RC_A = 2, R_LEN = 3, R_MAT_A = 4,
       R_KEEP = 5 };

template <int N> struct Shape;
template <> struct Shape<16> { static constexpr int V = 4, B = 1; };
template <> struct Shape<32> { static constexpr int V = 4, B = 2; };
template <> struct Shape<36> { static constexpr int V = 6, B = 1; };
template <> struct Shape<64> { static constexpr int V = 8, B = 1; };
template <> struct Shape<128> { static constexpr int V = 8, B = 2; };

// Transpose permutation over the full flat state (each branch's (V, V)
// view transposes on its own): repro's state_transpose_perm.
template <int V>
__device__ __forceinline__ int full_tperm(int j) {
  constexpr int T = V * V;
  return (j / T) * T + repro::tperm<V>(j % T);
}

template <int N>
__global__ void keystream_kernel(const int32_t* __restrict__ table, int n_ops,
                                 int init_key, const int32_t* __restrict__ key,
                                 const int32_t* __restrict__ rc,
                                 const int32_t* __restrict__ noise,
                                 const int32_t* __restrict__ mats,
                                 int32_t* __restrict__ out, int l, int lanes,
                                 ModQ m) {
  constexpr int V = Shape<N>::V, B = Shape<N>::B, T = V * V;
  static_assert(B * T == N, "state shape");
  extern __shared__ uint32_t smem[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;  // ragged tail: no barriers below
  const int xs = blockDim.x;
  uint32_t* x = smem + threadIdx.x;
  const size_t L = (size_t)lanes;
  const int32_t* rc_l = rc + lane;
  const int32_t* mat_l = mats != nullptr ? mats + lane : nullptr;

  for (int w = 0; w < N; ++w)
    x[w * xs] = init_key ? (uint32_t)__ldg(key + w) : (uint32_t)(w + 1);
  int width = N;

  for (int o = 0; o < n_ops; ++o) {
    const int32_t* r = table + kRec * o;
    const int kind = __ldg(r + R_KIND), f = __ldg(r + R_FLAGS);
    if (kind == OP_ARK) {
      // x + k ⊙ rc; a transposed ARK reads key and constants through the
      // transpose permutation (the reference's second key column and
      // rc_storage_perm).
      const int a = __ldg(r + R_RC_A), len = __ldg(r + R_LEN);
      const bool tr = f & F_T_IN;
      const bool defer = f & F_DEFER_OUT;
      for (int j = 0; j < len; ++j) {
        const int s = tr ? full_tperm<V>(j) : j;
        const uint32_t k = (uint32_t)__ldg(key + s);
        const uint32_t c = (uint32_t)__ldg(rc_l + (size_t)(a + s) * L);
        const uint32_t v = x[j * xs] + mod_mul(k, c, m);  // < 2q
        x[j * xs] = defer ? v : (v >= m.q ? v - m.q : v);
      }
    } else if (kind == OP_MRMC) {
      const bool t_in = f & F_T_IN, t_out = f & F_T_OUT;
      for (int b = 0; b < B; ++b) {
        uint32_t* xb = x + b * T * xs;
        if (f & F_STREAM) {
          repro::dense_matvec<V>(mat_l, L, __ldg(r + R_MAT_A) + b * T * T,
                                 t_in, t_out, xb, xs, xb, xs,
                                 f & F_LAZY_DENSE, m);
        } else {
          repro::mrmc_static<V>(xb, xs, xb, xs, t_in != t_out,
                                f & F_LAZY_ACC, m);
        }
      }
      const bool fold = f & F_FOLD_MIX;
      if (f & F_HAS_RC) {
        // additive constants, consumed in the output orientation
        const int a = __ldg(r + R_RC_A);
        for (int j = 0; j < N; ++j) {
          const int s = t_out ? full_tperm<V>(j) : j;
          const uint32_t v =
              x[j * xs] + (uint32_t)__ldg(rc_l + (size_t)(a + s) * L);
          x[j * xs] = fold ? v : (v >= m.q ? v - m.q : v);  // fold: < 2q
        }
      }
      if (f & F_MIX) {
        // (y_L, y_R) <- (2·y_L + y_R, y_L + 2·y_R)
        for (int j = 0; j < T; ++j) {
          const uint32_t yl = x[j * xs], yr = x[(T + j) * xs];
          if (fold) {  // inputs < 2q: one reduce of values < 6q
            const uint64_t s = (uint64_t)yl + yr;
            x[j * xs] = mod_reduce(s + yl, m);
            x[(T + j) * xs] = mod_reduce(s + yr, m);
          } else {
            const uint32_t s = mod_add(yl, yr, m);
            x[j * xs] = mod_add(s, yl, m);
            x[(T + j) * xs] = mod_add(s, yr, m);
          }
        }
      }
    } else if (kind == OP_NONLINEAR) {
      if (!(f & F_FEISTEL)) {
        for (int j = 0; j < width; ++j) {
          const uint32_t v = x[j * xs];
          x[j * xs] = mod_mul(mod_mul(v, v, m), v, m);
        }
      } else {
        // y_i = x_i + x_{i-1}^2 along the logical order of each branch.  In
        // transposed storage the logical predecessor of stored word s is
        // stored at tperm(tperm(s) - 1) (one row up, wrapping to
        // (v-1, r-1)); both candidates are register reads.
        const bool tr = f & F_T_IN;
        for (int b = 0; b < B; ++b) {
          uint32_t* xb = x + b * T * xs;
          uint32_t xr[T];
#pragma unroll
          for (int k = 0; k < T; ++k) xr[k] = xb[k * xs];
#pragma unroll
          for (int s = 0; s < T; ++s) {
            const int lt = repro::tperm<V>(s);
            const int pn_i = s == 0 ? 0 : s - 1;
            const int pt_i = lt == 0 ? 0 : repro::tperm<V>(lt - 1);
            const bool has = tr ? lt != 0 : s != 0;
            const uint32_t pv = tr ? xr[pt_i] : xr[pn_i];
            xb[s * xs] = has ? mod_add(xr[s], mod_mul(pv, pv, m), m) : xr[s];
          }
        }
      }
    } else if (kind == OP_TRUNCATE) {
      width = __ldg(r + R_KEEP);
    } else if (kind == OP_AGN) {
      if (noise != nullptr) {
        // signed noise folds to e + q for e < 0 (|e| < q)
        for (int j = 0; j < width; ++j) {
          const int32_t e = __ldg(noise + (size_t)j * L + lane);
          const uint32_t ev = e < 0 ? (uint32_t)(e + (int32_t)m.q) : (uint32_t)e;
          x[j * xs] = mod_add(x[j * xs], ev, m);
        }
      }
    }
  }
  for (int j = 0; j < l; ++j) out[(size_t)j * L + lane] = (int32_t)x[j * xs];
}

template <int N>
int launch(const int32_t* table, int n_ops, int init_key, const int32_t* key,
           const int32_t* rc, const int32_t* noise, const int32_t* mats,
           int32_t* out, int l, int lanes, ModQ m, cudaStream_t stream) {
  // 32 lanes per block: at serving width (4096 lanes) that spreads the
  // blocks over all 132 SMs.
  const int threads = 32;
  const int blocks = (lanes + threads - 1) / threads;
  const size_t smem = (size_t)N * threads * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        keystream_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  keystream_kernel<N><<<blocks, threads, smem, stream>>>(
      table, n_ops, init_key, key, rc, noise, mats, out, l, lanes, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_keystream(int n, const int32_t* table, int n_ops,
                               int init_key, const int32_t* key,
                               const int32_t* rc, const int32_t* noise,
                               const int32_t* mats, int32_t* out, int l,
                               int lanes, uint32_t q, uint64_t mu,
                               cudaStream_t stream) {
  if (lanes <= 0) return 0;
  const ModQ m{q, mu};
  switch (n) {
    case 16: return launch<16>(table, n_ops, init_key, key, rc, noise, mats, out, l, lanes, m, stream);
    case 32: return launch<32>(table, n_ops, init_key, key, rc, noise, mats, out, l, lanes, m, stream);
    case 36: return launch<36>(table, n_ops, init_key, key, rc, noise, mats, out, l, lanes, m, stream);
    case 64: return launch<64>(table, n_ops, init_key, key, rc, noise, mats, out, l, lanes, m, stream);
    case 128: return launch<128>(table, n_ops, init_key, key, rc, noise, mats, out, l, lanes, m, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
