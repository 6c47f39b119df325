// Device functions shared by the MRMC kernel (mrmc.cu) and the fused
// keystream kernel (keystream.cu): Z_q arithmetic, the circulant's
// coefficients, the transpose permutation and `mix_dot`, the one body of
// the static M·X·Mᵀ.  The MRMC kernel (`mrmc_static`) runs every entry of a
// state in one thread; the keystream kernel gives each word of the state
// to its own thread of the lane's group.
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

// Row i of M_v times the V words x[0], x[s], ..., x[(V-1)·s]: one entry of
// either half of M·X·Mᵀ.  The column mix is A[r][c] = mix_dot(r, X + c, V)
// and the row mix Y[r][c] = mix_dot(c, A + r·V, 1) (row-major (V, V)
// states).  lazy: the row sums its raw c·x terms in uint64 and reduces once
// (the plan's lazy-accumulate); otherwise every term is reduced before it
// is added, as the eager datapath does.  Inputs may be unreduced (< 2q
// after a deferred ARK); the output is canonical.
template <int V>
__device__ __forceinline__ uint32_t mix_dot(int i, const uint32_t* x, int s,
                                            bool lazy, ModQ m) {
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const uint64_t t = (uint64_t)mix_coef<V>(i, j) * x[j * s];
    acc += lazy ? t : (uint64_t)mod_reduce(t, m);
  }
  return mod_reduce(acc, m);
}

// y = M·X·Mᵀ (eager) for one (V, V) state stored row-major at x (word
// stride xs), in one thread.  The state is loaded into registers first, so
// y may alias x.
template <int V>
__device__ __forceinline__ void mrmc_static(const uint32_t* x, int xs,
                                            uint32_t* y, int ys, ModQ m) {
  uint32_t xr[V * V];
#pragma unroll
  for (int k = 0; k < V * V; ++k) xr[k] = x[k * xs];
#pragma unroll
  for (int r = 0; r < V; ++r) {
    uint32_t a[V];  // row r of the column mix
#pragma unroll
    for (int c = 0; c < V; ++c) a[c] = mix_dot<V>(r, xr + c, V, false, m);
#pragma unroll
    for (int c = 0; c < V; ++c)
      y[(r * V + c) * ys] = mix_dot<V>(c, a, 1, false, m);
  }
}

}  // namespace repro
