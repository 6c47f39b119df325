// Device functions shared by the MRMC kernel (mrmc.cu) and the fused
// keystream kernel (keystream.cu): Z_q arithmetic, the circulant's
// coefficients, the transpose permutation and `mix_dot`, the one body of
// the static M·X·Mᵀ.  Both kernels give each word of a state to its own
// thread of the state's group, which forms that word of each half of the
// product.
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
// states).  lazy: the row's raw terms are summed in uint64 and reduced
// once (the plan's lazy-accumulate), and since row i of the circulant is
// all ones plus 1 at column i and 2 at column i+1, that sum is
// Σ_j x[j] + x[i] + 2·x[i+1]: V + 2 loads and adds with no coefficient
// to form.  Otherwise every term is reduced before it is added, as the
// eager datapath does.  Inputs may be unreduced (< 2q after a deferred
// ARK); the output is canonical, and the same word either way.
template <int V>
__device__ __forceinline__ uint32_t mix_dot(int i, const uint32_t* x, int s,
                                            bool lazy, ModQ m) {
  uint64_t acc = 0;
  if (lazy) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc += x[j * s];
    const int i1 = i + 1 == V ? 0 : i + 1;
    return mod_reduce(acc + x[i * s] + 2ull * x[i1 * s], m);
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    acc += mod_reduce((uint64_t)mix_coef<V>(i, j) * x[j * s], m);
  return mod_reduce(acc, m);
}

}  // namespace repro
