// The producer's samplers: uniform mod q by stable rejection compaction,
// and the discrete Gaussian by inverse CDF, on the XOF's words.
//
// Replaces no TPU kernel: the reference samples in plain jnp
// (src/repro/crypto/sampler.py:55 `uniform_mod_q_stream`, :111
// `discrete_gaussian`), which XLA fuses on the TPU.  The port's plain
// versions (crypto/sampler.py) take a cumsum scatter over int64 rows and
// a (draws, 2·tail) compare and sum, a dozen eager launches a window with
// int64 temporaries: at rubato-128l's 140 032 lanes they took ~10 of the
// window's 11.6 device ms, far more than the AES kernel that draws the
// words.  These kernels read the AES kernel's int32 words (threefry's
// int64 ones alike) in place and write the engine's int64 planes.
//
// Bound: bytes.  A rubato-128l lane reads 324 words (204 for the uniform
// stream, 120 for 60 (hi, lo) draws) and writes 188 + 60 int64: 3.3 KB a
// lane, 0.14 ms a 140 032-lane window at 3.35 TB/s.  The work per word is
// a mask, a compare and a warp vote (uniform) or 2·tail 64-bit compares
// per draw (Gaussian: 32 at sigma = 1.6), well under the bytes' time.
//
// Design:
//  * Uniform (`sampler_uniform_kernel`): one warp per row.  The warp reads
//    its row's words in chunks of 32·kUnroll, one word a thread per step
//    (coalesced), all of a chunk's loads in flight before the first vote.
//    Per step a `__ballot_sync` marks the accepted candidates (low `bits`
//    bits below q) and each thread finds its stable slot as the running
//    count plus the accepted threads below it; accepted words below n_out
//    go out as int64, contiguous across the warp.  The warp stops reading
//    once n_out are accepted (rubato: 188-189 of 204 words).  Should the
//    row's words hold fewer than n_out accepted candidates, a second pass
//    writes the rejected ones in stream order, each mod q, into the slots
//    after them: the reference's stable argsort, bit for bit.
//  * Gaussian (`sampler_gauss_kernel`): one thread per draw.  The 2·tail
//    thresholds, 64-bit fixed point, sit in shared memory (256 bytes at
//    sigma = 1.6), read by all threads of a warp at once (a broadcast).
//    The draw (hi << 32 | lo) counts the thresholds it reaches, which is
//    the reference's lexicographic (hi, lo) compare, less tail.
//  * Word types: int32 bit patterns (the AES kernel's), read as unsigned,
//    or int64 values below 2^32 (threefry's); both through one template, so
//    no widening copy precedes either kernel.  Rows are strided views of
//    the producer's XOF rows (row stride given), so no slice is copied.
//
// Registers, shared memory and spills (nvcc -Xptxas -v for sm_90a), for
// int32 and int64 words alike: sampler_uniform_kernel 31 registers, no
// shared memory; sampler_gauss_kernel 32 registers, 8 bytes of dynamic
// shared memory a threshold (256 at sigma = 1.6); 0 bytes spilled, no
// stack frame.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // words a thread holds per chunk

template <typename W>
__device__ __forceinline__ uint32_t word_at(const W* __restrict__ p, int i) {
  return (uint32_t)p[i];  // int32: the bit pattern; int64: the value
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
sampler_uniform_kernel(const W* __restrict__ words, int64_t* __restrict__ out,
                       int rows, int row_stride, int n_words, int n_out,
                       uint32_t mask, uint32_t q) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int t = threadIdx.x & 31;
  const unsigned below = (1u << t) - 1u;
  const W* src = words + (size_t)row * row_stride;
  int64_t* dst = out + (size_t)row * n_out;
  int taken = 0;  // accepted so far: the same in every thread of the warp
  for (int base = 0; base < n_words && taken < n_out; base += 32 * kUnroll) {
    uint32_t c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + 32 * u + t;
      c[u] = i < n_words ? word_at(src, i) & mask : q;  // q: past the row
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = c[u] < q;
      const unsigned vote = __ballot_sync(0xffffffffu, ok);
      const int slot = taken + __popc(vote & below);
      if (ok && slot < n_out) dst[slot] = c[u];
      taken += __popc(vote);
    }
  }
  // fewer than n_out accepted: the rejected candidates follow, mod q
  for (int base = 0; base < n_words && taken < n_out; base += 32) {
    const int i = base + t;
    const uint32_t c = i < n_words ? word_at(src, i) & mask : 0u;
    const bool bad = i < n_words && c >= q;
    const unsigned vote = __ballot_sync(0xffffffffu, bad);
    const int slot = taken + __popc(vote & below);
    if (bad && slot < n_out) dst[slot] = c % q;
    taken += __popc(vote);
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
sampler_gauss_kernel(const W* __restrict__ hi, const W* __restrict__ lo,
                     int hi_stride, int lo_stride,
                     const uint64_t* __restrict__ thresholds, int n_thr,
                     int tail, int64_t* __restrict__ out, int rows, int n) {
  extern __shared__ uint64_t thr[];
  for (int k = threadIdx.x; k < n_thr; k += kThreads) thr[k] = thresholds[k];
  __syncthreads();
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)rows * n) return;
  const int r = (int)(idx / n), j = (int)(idx % n);
  const uint64_t u =
      ((uint64_t)word_at(hi + (size_t)r * hi_stride, j) << 32) |
      word_at(lo + (size_t)r * lo_stride, j);
  int count = 0;
  for (int k = 0; k < n_thr; ++k) count += u >= thr[k];
  out[idx] = count - tail;
}

}  // namespace

// words: row r's n_words words start at words + r·row_stride (elements of
// word_bytes = 4, int32 bit patterns, or 8, int64 values); out: (rows,
// n_out) int64.
extern "C" int repro_sampler_uniform(const void* words, int word_bytes,
                                     int rows, int row_stride, int n_words,
                                     int n_out, uint32_t mask, uint32_t q,
                                     int64_t* out, cudaStream_t stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  const int blocks = (rows + kWarps - 1) / kWarps;
  if (word_bytes == 4)
    sampler_uniform_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const int32_t*>(words), out, rows, row_stride, n_words,
        n_out, mask, q);
  else if (word_bytes == 8)
    sampler_uniform_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const int64_t*>(words), out, rows, row_stride, n_words,
        n_out, mask, q);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// hi, lo: row r's n draws start at hi + r·hi_stride and lo + r·lo_stride;
// thresholds: n_thr ascending 64-bit fixed-point values on the card; out:
// (rows, n) int64 in [-tail, n_thr - tail].
extern "C" int repro_sampler_gauss(const void* hi, const void* lo,
                                   int word_bytes, int rows, int hi_stride,
                                   int lo_stride, int n,
                                   const uint64_t* thresholds, int n_thr,
                                   int tail, int64_t* out,
                                   cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int64_t draws = (int64_t)rows * n;
  const int blocks = (int)((draws + kThreads - 1) / kThreads);
  const size_t smem = sizeof(uint64_t) * (size_t)n_thr;
  if (word_bytes == 4)
    sampler_gauss_kernel<<<blocks, kThreads, smem, stream>>>(
        static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
        hi_stride, lo_stride, thresholds, n_thr, tail, out, rows, n);
  else if (word_bytes == 8)
    sampler_gauss_kernel<<<blocks, kThreads, smem, stream>>>(
        static_cast<const int64_t*>(hi), static_cast<const int64_t*>(lo),
        hi_stride, lo_stride, thresholds, n_thr, tail, out, rows, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
