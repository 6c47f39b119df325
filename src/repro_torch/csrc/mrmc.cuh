// Device functions shared by the MRMC kernel (mrmc.cu) and the fused
// keystream kernel (keystream.cu): Z_q arithmetic, the static circulant
// M_v·X·M_vᵀ, and the dense per-lane t×t matvec of PASTA's streamed
// affine layers.
//
// Arithmetic.  The TPU datapath (repro/crypto/modmath.py) splits operands
// into 14-bit limbs because the TPU has no 64-bit integer multiply, and the
// reduction plan (repro/core/redplan.py) moves conditional-subtract chains
// around to save VPU steps.  Hopper multiplies 32x32->64 natively, so here
// a product is one widening multiply, sums accumulate in uint64, and one
// Barrett reduction brings a value back to [0, q).  Every op is a ring
// operation mod q, so reducing at each op's output lands on the same
// canonical words as the reference under either reduction mode.
#pragma once

#include <cstdint>

namespace repro {

// q < 2^28 and mu = floor(2^64 / q), computed on the host.
struct ModQ {
  uint32_t q;
  uint64_t mu;
};

// x mod q for any x < 2^63.  With x = Q·q + r0, the estimate
// qhat = floor(x·mu / 2^64) satisfies x/q - x/2^64 - 1 < qhat <= x/q, and
// x/2^64 < 1/2, so qhat is Q or Q-1 and one conditional subtract suffices.
__device__ __forceinline__ uint32_t mod_reduce(uint64_t x, ModQ m) {
  uint64_t qhat = __umul64hi(x, m.mu);
  uint64_t r = x - qhat * (uint64_t)m.q;
  if (r >= m.q) r -= m.q;
  return (uint32_t)r;
}

__device__ __forceinline__ uint32_t mod_mul(uint32_t a, uint32_t b, ModQ m) {
  return mod_reduce((uint64_t)a * b, m);
}

// a + b mod q for a, b < q.
__device__ __forceinline__ uint32_t mod_add(uint32_t a, uint32_t b, ModQ m) {
  uint32_t s = a + b;
  return s >= m.q ? s - m.q : s;
}

// Entry (i, j) of the circulant M_v with first row [2, 3, 1, ..., 1]
// (repro/core/params.py mix_matrix: row i is the first row rolled by i).
template <int V>
__device__ __forceinline__ uint32_t mix_coef(int i, int j) {
  const int d = (j - i + V) % V;
  return d == 0 ? 2u : (d == 1 ? 3u : 1u);
}

// The transpose permutation on one branch's flat row-major (V, V) index:
// stored position k of a transposed state holds logical element tperm(k).
// An involution.
template <int V>
__device__ __forceinline__ int tperm(int k) {
  return (k % V) * V + k / V;
}

// y = M·X·Mᵀ for one (V, V) state stored row-major at x (word stride xs),
// or its transpose when transpose_out is set (the schedule's orientation
// flip: the compute is the same, only where each output lands changes).
// The state is loaded into registers first, so y may alias x.
//
// lazy: each row sums its raw c·x terms in uint64 and reduces once (the
// plan's lazy-accumulate); otherwise every term is reduced before it is
// added, as the eager datapath does.  Inputs may be unreduced (< 2q after a
// deferred ARK); the output is canonical.
template <int V>
__device__ __forceinline__ void mrmc_static(const uint32_t* x, int xs,
                                            uint32_t* y, int ys,
                                            bool transpose_out, bool lazy,
                                            ModQ m) {
  uint32_t xr[V * V];
#pragma unroll
  for (int k = 0; k < V * V; ++k) xr[k] = x[k * xs];
#pragma unroll
  for (int r = 0; r < V; ++r) {
    // MixColumns, row r: a[c] = sum_j M[r][j] · X[j][c]
    uint32_t a[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      uint64_t acc = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        uint64_t term = (uint64_t)mix_coef<V>(r, j) * xr[j * V + c];
        acc += lazy ? term : (uint64_t)mod_reduce(term, m);
      }
      a[c] = mod_reduce(acc, m);
    }
    // MixRows: out[r][c] = sum_j M[c][j] · a[j]
#pragma unroll
    for (int c = 0; c < V; ++c) {
      uint64_t acc = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        uint64_t term = (uint64_t)mix_coef<V>(c, j) * a[j];
        acc += lazy ? term : (uint64_t)mod_reduce(term, m);
      }
      const int idx = transpose_out ? c * V + r : r * V + c;
      y[idx * ys] = mod_reduce(acc, m);
    }
  }
}

// Dense per-lane matvec for one branch, in stored-state order:
//   y_s[i] = sum_j M[p_out(i), p_in(j)] · x_s[j]  mod q
// where M is the branch's logical row-major t×t matrix, read from the
// lane-major matrix plane at word rows base .. base + t² (row stride
// `stride` words, already offset to this lane), and p_in/p_out are the
// transpose permutation when the op's input/output orientation is
// transposed.  This is what repro's mat_storage_perm pre-permutes on the
// host; the permutation is uniform across lanes, so reading through it
// keeps every load coalesced.
//
// lazy: raw 56-bit products accumulate in uint64 (t·q² < 2^62 for
// t = 64); otherwise each product is reduced first (the eager datapath).
// The state is loaded into registers first, so y may alias x.
template <int V>
__device__ __forceinline__ void dense_matvec(const int32_t* __restrict__ mat,
                                             size_t stride, int base,
                                             bool t_in, bool t_out,
                                             const uint32_t* x, int xs,
                                             uint32_t* y, int ys, bool lazy,
                                             ModQ m) {
  constexpr int T = V * V;
  uint32_t xr[T];
#pragma unroll
  for (int k = 0; k < T; ++k) xr[k] = x[k * xs];
  for (int i = 0; i < T; ++i) {
    const int pi = t_out ? tperm<V>(i) : i;
    const int32_t* row = mat + (size_t)(base + pi * T) * stride;
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int pj = t_in ? tperm<V>(j) : j;
      const uint64_t prod =
          (uint64_t)(uint32_t)__ldg(row + (size_t)pj * stride) * xr[j];
      acc += lazy ? prod : (uint64_t)mod_reduce(prod, m);
    }
    y[i * ys] = mod_reduce(acc, m);
  }
}

}  // namespace repro
