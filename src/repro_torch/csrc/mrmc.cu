// MRMC kernel: y = M_v·X·M_vᵀ mod q on a batch of (v, v) states.
//
// Replaces the Pallas kernel `_mrmc_kernel` (repro/kernels/mrmc/mrmc.py,
// launched by `mrmc_pallas`), which runs the product as add chains with
// conditional-subtract reduction on a (v, v, 128-lane) VMEM block.
//
// Bound: bytes.  Each state is read once and written once as the caller's
// int64 (2·8·v² bytes) against 2·v³ small-constant multiply-adds and 2·v²
// reductions: at v = 8 under 2 operations a byte, far below the card's
// operations-per-byte balance.  At a 4096-lane window the whole call moves
// 0.5-8 MB, so the launch itself is a large part of the time.
//
// Design.
//  * The caller's row-major (lanes, n) int64 states are read and written
//    where they lie: state s (a lane's branch) is words s·v² .. s·v²+v²-1
//    of the flat tensor, so no permute, narrowing or widening copy runs
//    around the kernel.  Values are below q < 2^28, so the low 32-bit word
//    of each element is all the arithmetic needs.
//  * A group of v² threads per state, one thread per word.  A span is S
//    consecutive states, as many as fit 256 threads (S·v² = 256, 252 or
//    256 threads for v = 4, 6, 8), and a block takes ITEMS = 2 spans: each
//    thread carries one word of each of two states and has both loads in
//    flight before it computes (with one load a thread, a block's 2 KB in
//    flight left HBM short of its rate at large batches).  Thread t loads
//    flat word (blockIdx·ITEMS + i)·S·v² + t of span i, so a warp reads
//    and writes 256 consecutive bytes: every access is coalesced.  At
//    pasta-128l (8192 states at 4096 lanes) that is 1024 blocks of 256
//    threads, where one thread per state gave 32 blocks on 132 SMs.
//  * The states are staged in shared memory.  Thread (r, c) of a group
//    forms word (r, c) of the column mix, A[r][c] = Σ_j M[r][j]·X[j][c];
//    after a barrier it forms word (r, c) of the row mix, Y[r][c] = Σ_j
//    M[c][j]·A[r][j], and stores it.  A v = 4 group is half a warp, so a
//    warp barrier replaces the block barrier there.  Both products are
//    `repro::mix_dot` (mrmc.cuh), the body the keystream kernel runs, in
//    its lazy form: raw terms summed through the circulant's structure
//    and one reduction a word and pass.  The outputs are canonical
//    residues of the same sums, so they are the reference's words.
//  * The ragged end of the last block loads nothing and stores nothing,
//    but meets every barrier.

#include <cuda_runtime.h>

#include <cstdint>

#include "mrmc.cuh"

namespace {

constexpr int ITEMS = 2;  // spans per block: states per thread group

// A span of v x v states: as many as fit 256 threads.
template <int V>
struct Group {
  static constexpr int T = V * V;
  static constexpr int S = 256 / T;
  static constexpr int THREADS = S * T;
};

template <int V>
__device__ __forceinline__ void group_sync() {
  if constexpr (32 % (V * V) == 0) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

template <int V>
__global__ void __launch_bounds__(Group<V>::THREADS)
mrmc_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ y,
            int64_t words, repro::ModQ m) {
  constexpr int T = Group<V>::T, THREADS = Group<V>::THREADS;
  __shared__ uint32_t xs[ITEMS][THREADS];  // the block's spans
  __shared__ uint32_t as[ITEMS][THREADS];  // their column mix

  const int t = threadIdx.x;
  const int k = t % T;     // word of the state
  const int base = t - k;  // the state's first word in its span
  const int r = k / V, c = k % V;
  int64_t w[ITEMS];
  uint32_t word[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    w[i] = ((int64_t)blockIdx.x * ITEMS + i) * THREADS + t;
    word[i] = w[i] < words ? (uint32_t)x[w[i]] : 0u;
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) xs[i][t] = word[i];
  group_sync<V>();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    as[i][t] = repro::mix_dot<V>(r, xs[i] + base + c, V, true, m);
  group_sync<V>();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const uint32_t out =
        repro::mix_dot<V>(c, as[i] + base + r * V, 1, true, m);
    if (w[i] < words) y[w[i]] = out;
  }
}

template <int V>
int launch(const int64_t* x, int64_t* y, int states, repro::ModQ m,
           cudaStream_t stream) {
  constexpr int per_block = Group<V>::S * ITEMS;
  const int blocks = (states + per_block - 1) / per_block;
  mrmc_kernel<V><<<blocks, Group<V>::THREADS, 0, stream>>>(
      x, y, (int64_t)states * Group<V>::T, m);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: `states` row-major (v, v) states of int64 words in [0, q), each
// state's v² words adjacent; y must not overlap x.
extern "C" int repro_mrmc(int v, const int64_t* x, int64_t* y, int states,
                          uint32_t q, uint64_t mu, cudaStream_t stream) {
  if (states <= 0) return 0;
  const repro::ModQ m{q, mu};
  switch (v) {
    case 4: return launch<4>(x, y, states, m, stream);
    case 6: return launch<6>(x, y, states, m, stream);
    case 8: return launch<8>(x, y, states, m, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
