// Fused keystream kernel: the whole HERA / Rubato / PASTA program per lane.
//
// Replaces the Pallas kernel `_keystream_kernel`
// (repro/kernels/keystream/keystream.py, launched by `keystream_pallas`),
// which unrolls the schedule at trace time over (n, 128-lane) VMEM blocks.
//
// Bound.  PASTA: bytes.  Each lane reads its rc words and its (r+1)·n·t
// matrix words once, as the producer's int64 (pasta-128l: 33.3 k words,
// 266 KB a lane, 1.09 GB a 4096-lane window, 0.33 ms at 3.35 TB/s; 0.16 ms
// if the planes were int32).  HERA and Rubato: a few hundred modular
// products per lane against a few KB, so operations in principle, and in
// practice the latency of the per-lane op chain at a 4096-lane window.
//
// Design.
//  * A group of G threads per lane (G = 16 for 4x4 branches, 64 for 6x6
//    and 8x8; a power of two >= the branch's t = v² words), L lanes per
//    thread block.  Thread g of a group owns word g of every branch and
//    keeps it in a register; at 4096 lanes that is 65 k-262 k threads, not
//    4096.  Ops that stay inside a word (ARK, cube, additive constants,
//    AGN, PASTA's branch mix, which pairs word g of the two branches) run
//    in registers.  Ops that mix words (static MRMC, Feistel, the dense
//    matvec) exchange through a per-lane area of shared memory between
//    block barriers; the op table is uniform across lanes, so every
//    thread of the block meets every barrier.
//  * No code generation: one kernel per state size N (16, 32, 36, 64, 128)
//    interprets the flat int32 op table that the host builds from the
//    port's Schedule and ReductionPlan (kernels/keystream/ops.py), so every
//    preset, variant and reduction mode runs through the same binary.
//  * The planes are read where the producer left them: row-major (lanes,
//    words) int64, no host copy.  A lane's words are contiguous, so the
//    threads of a group read consecutive addresses.  The storage-order
//    permutations of the reference (rc_storage_perm, mat_storage_perm and
//    its second, permuted key column) are applied to the word index here.
//  * Dense matvec (PASTA's streamed affine layers): each t×t branch matrix
//    of a lane (32 KB of int64 at t = 64) is copied into shared memory with
//    16-byte cp.async by the lane's group, two matrices in flight: the
//    next branch or layer loads while this one computes.  Thread g forms
//    row p_out(g); it walks the row's columns starting at column g, so the
//    threads of a warp read distinct banks, and multiplies column c by the
//    input word whose logical position is c (the input is written to shared
//    memory in logical order, so those reads are conflict-free too).
//  * The keystream is written row-major (lanes, l) as int64, the engine's
//    dtype: no transpose or widening copy after the kernel.
//  * Arithmetic: 64-bit products, uint64 accumulators, Barrett reduction to
//    [0, q) at each op's output (mrmc.cuh).  The plan's flags still choose
//    the datapath (deferred ARK output, lazy accumulation, lazy dense
//    products, folded branch mix) and both modes give the same words.
//
// Registers, shared memory and spills (nvcc -Xptxas -v for sm_90a), per
// state size N: 16 -> 48 registers, 32 -> 56, 36 -> 56,
// 64 -> 48, 128 -> 58; every instantiation 0 bytes spilled, no stack
// frame.  Dynamic shared memory per thread block: L·2·N words (1-2 KB), plus
// the matrix ring L·2·t² int64 for the streaming presets: 34 KB at N = 32
// (8 lanes), 65 KB at N = 128 (1 lane; three blocks per SM).

#include <cuda_runtime.h>

#include <cstdint>

#include "mrmc.cuh"

namespace {

using repro::ModQ;
using repro::mix_dot;
using repro::mod_add;
using repro::mod_mul;
using repro::mod_reduce;
using repro::tperm;

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
// record fields (R_MAT_A = 4 is not read: streaming ops consume the
// lane's branch matrices in plane order, which the ring prefetches)
enum { R_KIND = 0, R_FLAGS = 1, R_RC_A = 2, R_LEN = 3, R_KEEP = 5 };

// Per state size: branch side V, branches B, threads per lane G, lanes per
// thread block L (kernels/keystream/ops.py KERNEL_SHAPE mirrors this).
template <int N> struct Shape;
template <> struct Shape<16> { static constexpr int V = 4, B = 1, G = 16, L = 8; };
template <> struct Shape<32> { static constexpr int V = 4, B = 2, G = 16, L = 8; };
template <> struct Shape<36> { static constexpr int V = 6, B = 1, G = 64, L = 2; };
template <> struct Shape<64> { static constexpr int V = 8, B = 1, G = 64, L = 2; };
template <> struct Shape<128> { static constexpr int V = 8, B = 2, G = 64, L = 1; };

// Transpose permutation over the full flat state (each branch's (V, V)
// view transposes on its own): repro's state_transpose_perm.
template <int V>
__device__ __forceinline__ int full_tperm(int j) {
  constexpr int T = V * V;
  return (j / T) * T + tperm<V>(j % T);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Row `row` of a staged t×t int64 matrix (values < q, so the low words
// suffice) times the logical-order input xl, starting at column `start`.
template <int T>
__device__ __forceinline__ uint32_t dense_row(const uint64_t* mat,
                                              const uint32_t* xl, int row,
                                              int start, bool lazy, ModQ m) {
  const uint32_t* mr = reinterpret_cast<const uint32_t*>(mat + row * T);
  uint64_t acc = 0;
  if (lazy) {  // raw products: t·(2q)² < 2^64
#pragma unroll 8
    for (int c = start; c < T; ++c) acc += (uint64_t)mr[2 * c] * xl[c];
#pragma unroll 8
    for (int c = 0; c < start; ++c) acc += (uint64_t)mr[2 * c] * xl[c];
  } else {
#pragma unroll 4
    for (int c = start; c < T; ++c)
      acc += mod_reduce((uint64_t)mr[2 * c] * xl[c], m);
#pragma unroll 4
    for (int c = 0; c < start; ++c)
      acc += mod_reduce((uint64_t)mr[2 * c] * xl[c], m);
  }
  return mod_reduce(acc, m);
}

template <int N>
__global__ void __launch_bounds__(Shape<N>::G * Shape<N>::L)
keystream_kernel(const int32_t* __restrict__ table, int n_ops, int init_key,
                 const int64_t* __restrict__ key,
                 const int64_t* __restrict__ rc, int n_rc,
                 const int64_t* __restrict__ noise,
                 const int64_t* __restrict__ mats, int n_mat,
                 int64_t* __restrict__ out, int l, int lanes, ModQ m) {
  using Sh = Shape<N>;
  constexpr int V = Sh::V, B = Sh::B, G = Sh::G, L = Sh::L, T = V * V;
  constexpr int TT = T * T;
  static_assert(B * T == N && T <= G, "state shape");
  extern __shared__ __align__(16) unsigned char smem[];

  const int g = threadIdx.x % G;    // owns word g of every branch
  const int sub = threadIdx.x / G;  // lane within the thread block
  const int lane = blockIdx.x * L + sub;
  const bool live = lane < lanes;
  const int ld = live ? lane : lanes - 1;  // ragged tail: read, never write
  const bool own = g < T;

  // shared memory: [L][2][TT] matrix ring (streaming tables only), then
  // [L][2][N] words: xs (exchange) and as (MRMC column-mix partials)
  const int n_mats = mats != nullptr ? n_mat / TT : 0;
  uint64_t* ring = reinterpret_cast<uint64_t*>(smem) + (size_t)sub * 2 * TT;
  uint32_t* xs = reinterpret_cast<uint32_t*>(
                     reinterpret_cast<uint64_t*>(smem) +
                     (mats != nullptr ? (size_t)L * 2 * TT : 0)) +
                 sub * 2 * N;
  uint32_t* as = xs + N;
  const int64_t* rc_l = rc + (size_t)ld * n_rc;
  const int64_t* mat_l = mats != nullptr ? mats + (size_t)ld * n_mat : nullptr;

  // Matrix k of the lane into ring slot k % 2 (an empty group past the
  // end keeps the wait count uniform).
  auto stage = [&](int k) {
    if (k < n_mats) {
      const int64_t* src = mat_l + (size_t)k * TT;
      uint64_t* dst = ring + (k & 1) * TT;
      for (int c = g; c < TT / 2; c += G) cp_async16(dst + 2 * c, src + 2 * c);
    }
    cp_async_commit();
  };
  if (n_mats > 0) {
    stage(0);
    stage(1);
  }

  uint32_t x[B], kn[B], kt[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = b * T + g;
    kn[b] = own ? (uint32_t)__ldg(key + j) : 0u;
    kt[b] = own ? (uint32_t)__ldg(key + full_tperm<V>(j)) : 0u;
    x[b] = init_key ? kn[b] : (uint32_t)(j + 1);
  }
  int width = N;
  int k_mat = 0;

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
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int j = b * T + g;
        if (own && j < len) {
          const int s = tr ? full_tperm<V>(j) : j;
          const uint32_t c = (uint32_t)rc_l[a + s];
          const uint32_t v = x[b] + mod_mul(tr ? kt[b] : kn[b], c, m);
          x[b] = defer ? v : (v >= m.q ? v - m.q : v);  // v < 2q
        }
      }
    } else if (kind == OP_MRMC) {
      const bool t_in = f & F_T_IN, t_out = f & F_T_OUT;
      if (f & F_STREAM) {
        const bool lazy = f & F_LAZY_DENSE;
#pragma unroll
        for (int b = 0; b < B; ++b) {
          __syncthreads();  // earlier readers of xs are done
          if (own) xs[t_in ? tperm<V>(g) : g] = x[b];
          cp_async_wait1();  // this thread's copies of matrix k_mat landed
          __syncthreads();   // ... and everyone's
          if (own)
            x[b] = dense_row<T>(ring + (k_mat & 1) * TT, xs,
                                t_out ? tperm<V>(g) : g, g, lazy, m);
          __syncthreads();  // slot k_mat % 2 is free again
          stage(k_mat + 2);
          ++k_mat;
        }
      } else {
        // y = M·X·Mᵀ per branch (mrmc.cuh mix_dot): column mix into as,
        // then row mix.  The orientation flip is only which (row, col) a
        // position computes.
        const bool lazy = f & F_LAZY_ACC;
        const int rg = g / V, cg = g % V;
        const bool flip = t_in != t_out;
        const int R = flip ? cg : rg, C = flip ? rg : cg;
        __syncthreads();
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (own) xs[b * T + g] = x[b];
        __syncthreads();
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (own) as[b * T + g] = mix_dot<V>(rg, xs + b * T + cg, V, lazy, m);
        __syncthreads();
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (own) x[b] = mix_dot<V>(C, as + b * T + R * V, 1, lazy, m);
      }
      const bool fold = f & F_FOLD_MIX;
      if (own && (f & F_HAS_RC)) {
        // additive constants, consumed in the output orientation
        const int a = __ldg(r + R_RC_A);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int j = b * T + g;
          const int s = t_out ? full_tperm<V>(j) : j;
          const uint32_t v = x[b] + (uint32_t)rc_l[a + s];
          x[b] = fold ? v : (v >= m.q ? v - m.q : v);  // fold: < 2q
        }
      }
      if constexpr (B == 2) {
        if (own && (f & F_MIX)) {
          // (y_L, y_R) <- (2·y_L + y_R, y_L + 2·y_R): word g of each branch
          const uint32_t yl = x[0], yr = x[1];
          if (fold) {  // inputs < 2q: one reduce of values < 6q
            const uint64_t s = (uint64_t)yl + yr;
            x[0] = mod_reduce(s + yl, m);
            x[1] = mod_reduce(s + yr, m);
          } else {
            const uint32_t s = mod_add(yl, yr, m);
            x[0] = mod_add(s, yl, m);
            x[1] = mod_add(s, yr, m);
          }
        }
      }
    } else if (kind == OP_NONLINEAR) {
      if (!(f & F_FEISTEL)) {
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (own && b * T + g < width) x[b] = mod_mul(mod_mul(x[b], x[b], m), x[b], m);
      } else {
        // y_s = x_s + x_pred(s)^2 along the logical order of each branch.
        // In transposed storage the logical predecessor of stored word s
        // is stored at tperm(tperm(s) - 1) (one row up, wrapping to
        // (v-1, r-1)).
        const bool tr = f & F_T_IN;
        __syncthreads();
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (own) xs[b * T + g] = x[b];
        __syncthreads();
        const int lt = tperm<V>(g);
        const bool has = tr ? lt != 0 : g != 0;
        const int pred = tr ? tperm<V>(lt == 0 ? 0 : lt - 1) : (g == 0 ? 0 : g - 1);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          if (own && has) {
            const uint32_t pv = xs[b * T + pred];
            x[b] = mod_add(x[b], mod_mul(pv, pv, m), m);
          }
        }
      }
    } else if (kind == OP_TRUNCATE) {
      width = __ldg(r + R_KEEP);
    } else if (kind == OP_AGN) {
      if (noise != nullptr) {
        // signed noise folds to e + q for e < 0 (|e| < q)
        const int64_t* e_l = noise + (size_t)ld * l;
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int j = b * T + g;
          if (own && j < width) {
            const int64_t e = e_l[j];
            const uint32_t ev = (uint32_t)(e < 0 ? e + m.q : e);
            x[b] = mod_add(x[b], ev, m);
          }
        }
      }
    }
  }
  if (own && live) {
    int64_t* o = out + (size_t)lane * l;
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (b * T + g < l) o[b * T + g] = (int64_t)x[b];
  }
}

template <int N>
int launch(const int32_t* table, int n_ops, int init_key, const int64_t* key,
           const int64_t* rc, int n_rc, const int64_t* noise,
           const int64_t* mats, int n_mat, int64_t* out, int l, int lanes,
           ModQ m, cudaStream_t stream) {
  using Sh = Shape<N>;
  constexpr int TT = Sh::V * Sh::V * Sh::V * Sh::V;
  const int threads = Sh::G * Sh::L;
  const int blocks = (lanes + Sh::L - 1) / Sh::L;
  constexpr size_t kWords = (size_t)Sh::L * 2 * N * 4;
  constexpr size_t kMost = (size_t)Sh::L * 2 * TT * 8 + kWords;
  const size_t smem = (mats != nullptr ? kMost : kWords);
  if (kMost > 48 * 1024) {  // per launch: the attribute is per device
    const cudaError_t e = cudaFuncSetAttribute(
        keystream_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMost);
    if (e != cudaSuccess) return (int)e;
  }
  keystream_kernel<N><<<blocks, threads, smem, stream>>>(
      table, n_ops, init_key, key, rc, n_rc, noise, mats, n_mat, out, l,
      lanes, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_keystream(int n, const int32_t* table, int n_ops,
                               int init_key, const int64_t* key,
                               const int64_t* rc, int n_rc,
                               const int64_t* noise, const int64_t* mats,
                               int n_mat, int64_t* out, int l, int lanes,
                               uint32_t q, uint64_t mu, cudaStream_t stream) {
  if (lanes <= 0) return 0;
  const ModQ m{q, mu};
#define REPRO_KS(N)                                                         \
  case N:                                                                   \
    return launch<N>(table, n_ops, init_key, key, rc, n_rc, noise, mats,    \
                     n_mat, out, l, lanes, m, stream)
  switch (n) {
    REPRO_KS(16);
    REPRO_KS(32);
    REPRO_KS(36);
    REPRO_KS(64);
    REPRO_KS(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_KS
}
