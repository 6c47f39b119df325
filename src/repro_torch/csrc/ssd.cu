// The Mamba-2 SSD (state-space duality) chunked scan, forward and
// backward, for the train and prefill paths.
//
// Replaces no TPU kernel: the reference's `ssd_chunked`
// (src/repro/models/mamba2.py) is plain jnp, which XLA fuses on the TPU.
// The port's plain version (models/mamba2.py `ssd_chunked`) builds several
// (B, chunks, L, L, heads) float32 tensors a call (the decay, its mask,
// the scores), each 1.07 GB at granite-4.0-h-small's widths (T 8192, L 256,
// 128 heads), and autograd keeps and rebuilds them for the backward: some
// 13 GB of device traffic a forward, ~1.6 s of a 5-s train step.  These
// kernels keep every L x L x heads intermediate in registers and shared
// memory.  What reaches device memory: the inputs, y, the chunk-boundary
// states (B, chunks, heads, P, S) in float32, and small per-chunk vectors.
//
// Bound: float32 operations.  A forward is 51.8 GFLOP at granite's widths
// (the intra-chunk product on its causal half, the chunk states, the
// inter-chunk output: each (L x P x S or L x L x P) per chunk and head),
// 0.77 ms at the card's 67 TFLOP/s of FFMA, against 0.42 GB of bytes
// (0.12 ms); the backward needs 104 GFLOP (1.55 ms), and this design
// computes 121 GFLOP of it: one L x P x S product a chunk and head again
// (dx_kernel's C h^T, since dbc_kernel sums dC over heads) and C B^T
// again (chip_smoke.py `ssd_work`).
// Every product and sum is float32 FFMA: x, B and C are read in their
// dtype and widened in registers (exact), y and the input gradients are
// rounded to that dtype once.
//
// Design (against that bound: the FLOPs as register-tiled FFMA fed from
// shared memory, the L x L work on the causal half only; the bytes each
// input and output once, plus the chunk states):
//  * Every product is a register-tiled FFMA GEMM over tiles in shared
//    memory (`mma_tile`): 256 threads, each an 8x8, 4x8 or 4x4 block of
//    outputs, operands staged as [k][row] float32 (widened, scaled, masked
//    on the way in), read as 16-byte broadcasts (A) and conflict-free
//    16-byte rows (B).  One design covers every shape by masking: P <= 64
//    and S <= 128 (multiples of 4), any chunk length L <= 256.
//  * Forward (5 launches): `cumsum_kernel` (the chunk cumsum of dt*A, one
//    summation order that every later kernel reads); `cb_kernel` (C B^T a
//    chunk, shared by all heads: n_groups is 1); `states_kernel` (a chunk's
//    state, (P x L)(L x S), per chunk and head); `fwd_rec_kernel` (the
//    sequential pass over chunks, per head and 1024 state entries, h0 in,
//    the state before each chunk kept in place, h_final out); `out_kernel`
//    (per chunk and head: C h^T decayed, plus the intra-chunk product whose
//    scores CB[l,m] exp(a_l - a_m) dt_m are built in shared memory a
//    32-column tile at a time, masked before the exponential, and skipped
//    by whole warps above the diagonal).
//  * Backward (8 launches): the cumsum and CB again; `states_kernel` on
//    (exp(a) dy, C) for the gradient each chunk's state receives from its
//    own output; `bwd_rec_kernel`, the reverse pass (dh0 out, the state
//    gradients in place, the decay's share per chunk); `dx_kernel` (per
//    chunk and head: dx from the state gradient and the transposed scores,
//    the chunk state's dt share, the inter output's a share); `dcb_kernel`
//    (per chunk and 64x64 causal tile, a loop over heads: dy x^T, the
//    head-summed dCB, and row and column partial sums for dt and a);
//    `dbc_kernel` (dB and dC as one GEMM over heads x P plus dCB's own
//    product, per chunk and 64x64 output tile, no atomics); `final_kernel`
//    (per chunk and head: the partials summed, the reverse cumsum back to
//    dt and A).  Every sum has a fixed order, so a run repeats bit for bit.
//
// Registers, shared memory and spills (nvcc -Xptxas -v for sm_90a, the
// bfloat16 instances; float32 alike): out_kernel and dx_kernel 128 (capped
// for two 256-thread blocks an SM; 44 and 128 bytes spilled), 43 KB of
// shared memory; dcb_kernel 99, 35 KB; dbc_kernel 43, 32 KB; states_kernel
// 75, 26 KB; cb_kernel 63, 16 KB; the passes over chunks, the cumsum and
// final_kernel 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 256;
constexpr int kTile = 64;  // row and column tile of the per-chunk products

struct Shape {
  int B, T, H, P, S, L, NC;
  int Lp;  // L rounded up to kTile: the row stride of CB and dCB
  int nt;  // Lp / kTile
  int nq;  // 1024-entry slices of a (P, S) state
};

struct One {
  __device__ float operator()(int) const { return 1.f; }
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  u.x = bf16_bits(v.x) | (bf16_bits(v.y) << 16);
  u.y = bf16_bits(v.z) | (bf16_bits(v.w) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[k][r] = scale(r) * src[r * ld + k0 + k] for a ROWS x KT tile of a
// row-major matrix (rows r < nrows, columns k0 + k < ncols, else 0).
// ncols and k0 are multiples of 4.
template <int ROWS, int KT, typename T, typename F>
__device__ __forceinline__ void load_t(float (*dst)[ROWS], const T* src, size_t ld,
                                       int nrows, int ncols, int k0, F scale) {
  constexpr int kEpt = KT * ROWS / kThreads;  // elements a thread
  const int r = threadIdx.x % ROWS;
  const int kb = (threadIdx.x / ROWS) * kEpt;
  const bool rv = r < nrows;
  const float sc = rv ? scale(r) : 0.f;
  const T* row = src + (size_t)r * ld + k0 + kb;
#pragma unroll
  for (int q = 0; q < kEpt; q += 4) {
    float4 v = zero4();
    if (rv && k0 + kb + q < ncols) v = load4(row + q);
    dst[kb + q][r] = v.x * sc;
    dst[kb + q + 1][r] = v.y * sc;
    dst[kb + q + 2][r] = v.z * sc;
    dst[kb + q + 3][r] = v.w * sc;
  }
}

// dst[k][n] = scale(k) * src[k * ld + c0 + n] for a KT x N tile (rows
// k < nrows, columns c0 + n < ncols, else 0).  ncols and c0 are multiples
// of 4.
template <int N, int KT, typename T, typename F>
__device__ __forceinline__ void load_k(float (*dst)[N], const T* src, size_t ld, int nrows,
                                       int ncols, int c0, F scale) {
  constexpr int kTpr = N / 4;             // threads a row
  constexpr int kRpp = kThreads / kTpr;   // rows a pass
  const int col = (threadIdx.x % kTpr) * 4;
  const bool cv = c0 + col < ncols;
#pragma unroll
  for (int k = threadIdx.x / kTpr; k < KT; k += kRpp) {
    float4 v = zero4();
    if (cv && k < nrows) {
      v = load4(src + (size_t)k * ld + c0 + col);
      const float sc = scale(k);
      v.x *= sc;
      v.y *= sc;
      v.z *= sc;
      v.w *= sc;
    }
    store4(&dst[k][col], v);
  }
}

// acc[i][j] += sum_k As[k][row i] * Bs[k][col j]: thread (ty, tx) of
// (BM / TM, BN / TN) holds rows ty*TM + i and columns col_of(j).
template <int BN, int TN>
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j / 4) * (BN / TN) * 4 + tx * 4 + (j % 4);
}

template <int BM, int BN, int TM, int TN, int KT>
__device__ __forceinline__ void mma_tile(const float (*As)[BM], const float (*Bs)[BN],
                                         float (&acc)[TM][TN]) {
  constexpr int kNtx = BN / TN;
  const int tx = threadIdx.x % kNtx, ty = threadIdx.x / kNtx;
#pragma unroll 4
  for (int k = 0; k < KT; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&As[k][ty * TM + i]);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
    }
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(&Bs[k][g * kNtx * 4 + tx * 4]);
      b[4 * g] = v.x;
      b[4 * g + 1] = v.y;
      b[4 * g + 2] = v.z;
      b[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// (i, j), j <= i, of the t-th lower-triangular tile in row order.
__device__ __forceinline__ void tri(int t, int& i, int& j) {
  i = 0;
  while (t > i) {
    t -= i + 1;
    ++i;
  }
  j = t;
}

// ---------------------------------------------------------------- forward

// acs[b, c, h, l] = cumsum over the chunk of dt * A (one thread a head).
__global__ void cumsum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                              float* __restrict__ acs, Shape s) {
  const int bc = blockIdx.x, b = bc / s.NC, c = bc % s.NC;
  for (int h = threadIdx.x; h < s.H; h += blockDim.x) {
    const float a = A[h];
    const float* d = dt + ((size_t)b * s.T + (size_t)c * s.L) * s.H + h;
    float* out = acs + ((size_t)bc * s.H + h) * s.L;
    float run = 0.f;
    for (int l = 0; l < s.L; ++l) {
      run += d[(size_t)l * s.H] * a;
      out[l] = run;
    }
  }
}

// cb[bc, l, m] = sum_s C[l, s] B[m, s] on the 64x64 tiles with m-tile <=
// l-tile (the rest is never read).
template <typename T>
__global__ void __launch_bounds__(kThreads) cb_kernel(const T* __restrict__ Bm,
                                                      const T* __restrict__ Cm,
                                                      float* __restrict__ cb, Shape s) {
  __shared__ __align__(16) float As[32][kTile];
  __shared__ __align__(16) float Bs[32][kTile];
  int it, jt;
  tri(blockIdx.x, it, jt);
  const int bc = blockIdx.y, b = bc / s.NC, c = bc % s.NC;
  const size_t row0 = (size_t)b * s.T + (size_t)c * s.L;
  const int l0 = it * kTile, m0 = jt * kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < s.S; k0 += 32) {
    load_t<kTile, 32>(As, Cm + (row0 + l0) * s.S, s.S, s.L - l0, s.S, k0, One());
    load_t<kTile, 32>(Bs, Bm + (row0 + m0) * s.S, s.S, s.L - m0, s.S, k0, One());
    __syncthreads();
    mma_tile<kTile, kTile, 4, 4, 32>(As, Bs, acc);
    __syncthreads();
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = cb + (size_t)bc * s.Lp * s.Lp;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    store4(out + (size_t)(l0 + ty * 4 + i) * s.Lp + m0 + tx * 4,
           make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

// out[bc, h, p, s] = sum_l sx[l] X[l, h, p] * sy[l] Y[l, s] over a chunk.
// mode 0 (a chunk's state): X = x, Y = B, sx = 1, sy = exp(a_end - a_l) dt_l.
// mode 1 (the state gradient from the chunk's output): X = dy, Y = C,
// sx = exp(a_l), sy = 1.
template <typename T>
__global__ void __launch_bounds__(kThreads) states_kernel(
    const T* __restrict__ X, const T* __restrict__ Y, const float* __restrict__ dt,
    const float* __restrict__ acs, float* __restrict__ out, Shape s, int mode) {
  __shared__ __align__(16) float As[32][64];
  __shared__ __align__(16) float Bs[32][128];
  __shared__ float sx[kMaxL], sy[kMaxL];
  const int h = blockIdx.x, bc = blockIdx.y, b = bc / s.NC, c = bc % s.NC;
  const size_t row0 = (size_t)b * s.T + (size_t)c * s.L;
  const float* a = acs + ((size_t)bc * s.H + h) * s.L;
  for (int l = threadIdx.x; l < s.L; l += kThreads) {
    if (mode == 0) {
      sx[l] = 1.f;
      sy[l] = expf(a[s.L - 1] - a[l]) * dt[(row0 + l) * s.H + h];
    } else {
      sx[l] = expf(a[l]);
      sy[l] = 1.f;
    }
  }
  __syncthreads();
  const size_t hp = (size_t)s.H * s.P;
  const T* xb = X + (row0 * s.H + h) * s.P;
  const T* yb = Y + row0 * s.S;
  float acc[4][8] = {};
  for (int l0 = 0; l0 < s.L; l0 += 32) {
    load_k<64, 32>(As, xb + (size_t)l0 * hp, hp, s.L - l0, s.P, 0,
                   [&](int k) { return sx[l0 + k]; });
    load_k<128, 32>(Bs, yb + (size_t)l0 * s.S, s.S, s.L - l0, s.S, 0,
                    [&](int k) { return sy[l0 + k]; });
    __syncthreads();
    mma_tile<64, 128, 4, 8, 32>(As, Bs, acc);
    __syncthreads();
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* o = out + ((size_t)bc * s.H + h) * s.P * s.S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty * 4 + i;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int sc = col_of<128, 8>(tx, 4 * g);
      if (p < s.P && sc < s.S)
        store4(o + (size_t)p * s.S + sc, make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                                     acc[i][4 * g + 2], acc[i][4 * g + 3]));
    }
  }
}

// The pass over chunks: states[c] (a chunk's own state) becomes the state
// before chunk c; h_{c+1} = h_c exp(a_end[c]) + state[c].
__global__ void __launch_bounds__(kThreads) fwd_rec_kernel(float* __restrict__ states,
                                                           const float* __restrict__ acs,
                                                           const float* __restrict__ h0,
                                                           float* __restrict__ hT, Shape s) {
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const size_t ps = (size_t)s.P * s.S;
  const int e = blockIdx.x * 1024 + threadIdx.x * 4;
  if (e >= (int)ps) return;
  float4 hv = h0 ? load4(h0 + bh * ps + e) : zero4();
  for (int c = 0; c < s.NC; ++c) {
    const size_t hb = ((size_t)b * s.NC + c) * s.H + h;
    float* p = states + hb * ps + e;
    const float4 st = load4(p);
    store4(p, hv);
    const float d = expf(acs[hb * s.L + s.L - 1]);
    hv = make_float4(hv.x * d + st.x, hv.y * d + st.y, hv.z * d + st.z, hv.w * d + st.w);
  }
  store4(hT + bh * ps + e, hv);
}

// y[l, h, :] = exp(a_l) sum_s C[l, s] h_c[:, s]
//            + sum_{m <= l} CB[l, m] exp(a_l - a_m) dt_m x[m, h, :]
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) out_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Cm,
    const float* __restrict__ acs, const float* __restrict__ cb,
    const float* __restrict__ chunk_h, T* __restrict__ y, Shape s) {
  __shared__ __align__(16) float As[32][kMaxL];
  __shared__ __align__(16) float Bs[32][64];
  __shared__ float sa[kMaxL], sd[kMaxL];
  const int tid = threadIdx.x, warp = tid / 32;
  const int h = blockIdx.x, bc = blockIdx.y, b = bc / s.NC, c = bc % s.NC;
  const size_t row0 = (size_t)b * s.T + (size_t)c * s.L;
  const size_t hp = (size_t)s.H * s.P;
  if (tid < s.L) {
    sa[tid] = acs[((size_t)bc * s.H + h) * s.L + tid];
    sd[tid] = dt[(row0 + tid) * s.H + h];
  }
  float acc[8][8] = {};
  const float* hc = chunk_h + ((size_t)bc * s.H + h) * s.P * s.S;
  for (int k0 = 0; k0 < s.S; k0 += 32) {
    load_t<kMaxL, 32>(As, Cm + row0 * s.S, s.S, s.L, s.S, k0, One());
    load_t<64, 32>(Bs, hc, s.S, s.P, s.S, k0, One());
    __syncthreads();
    mma_tile<kMaxL, 64, 8, 8, 32>(As, Bs, acc);
    __syncthreads();
  }
  const int tx = tid % 8, ty = tid / 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = ty * 8 + i;
    const float e = l < s.L ? expf(sa[l]) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] *= e;
  }
  const T* xb = x + (row0 * s.H + h) * s.P;
  const float* cbb = cb + (size_t)bc * s.Lp * s.Lp;
  for (int m0 = 0; m0 < s.L; m0 += 32) {
    const int l = tid;
    if (l >= m0) {  // the rows of the warps that work on this tile
      if (l < s.L) {
        const float* crow = cbb + (size_t)l * s.Lp + m0;
        const float al = sa[l];
#pragma unroll
        for (int q = 0; q < 32; q += 4) {
          const float4 v = load4(crow + q);
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int m = m0 + q + u;
            As[q + u][l] = m <= l ? (vv[u] * expf(al - sa[m])) * sd[m] : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < 32; ++q) As[q][l] = 0.f;
      }
    }
    load_k<64, 32>(Bs, xb + (size_t)m0 * hp, hp, s.L - m0, s.P, 0, One());
    __syncthreads();
    if (warp >= m0 / 32) mma_tile<kMaxL, 64, 8, 8, 32>(As, Bs, acc);
    __syncthreads();
  }
  T* yb = y + (row0 * s.H + h) * s.P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = ty * 8 + i;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int p = col_of<64, 8>(tx, 4 * g);
      if (l < s.L && p < s.P)
        store4(yb + (size_t)l * hp + p, make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                                    acc[i][4 * g + 2], acc[i][4 * g + 3]));
    }
  }
}

// --------------------------------------------------------------- backward

// The reverse pass: g = dh_final; for c down: the dot g . h_c (the decay's
// share of a_end[c], per warp), dst[c] = g (in place of the chunk's own
// output share Q[c]), g = g exp(a_end[c]) + Q[c]; dh0 = g.
__global__ void __launch_bounds__(kThreads) bwd_rec_kernel(
    float* __restrict__ qbuf, const float* __restrict__ chunk_h, const float* __restrict__ acs,
    const float* __restrict__ dhT, float* __restrict__ dh0, float* __restrict__ recpart,
    Shape s) {
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const size_t ps = (size_t)s.P * s.S;
  const int e = blockIdx.x * 1024 + threadIdx.x * 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool v = e < (int)ps;
  float4 g = (v && dhT) ? load4(dhT + bh * ps + e) : zero4();
  for (int c = s.NC - 1; c >= 0; --c) {
    const size_t hb = ((size_t)b * s.NC + c) * s.H + h;
    float part = 0.f;
    float4 q = zero4();
    if (v) {
      q = load4(qbuf + hb * ps + e);
      const float4 hc = load4(chunk_h + hb * ps + e);
      part = g.x * hc.x + g.y * hc.y + g.z * hc.z + g.w * hc.w;
      store4(qbuf + hb * ps + e, g);
    }
    part = warp_sum(part);
    if (lane == 0) recpart[(hb * s.nq + blockIdx.x) * 8 + warp] = part;
    const float d = expf(acs[hb * s.L + s.L - 1]);
    g = make_float4(g.x * d + q.x, g.y * d + q.y, g.z * d + q.z, g.w * d + q.w);
  }
  if (v && dh0) store4(dh0 + bh * ps + e, g);
}

// Per chunk and head, rows m of the chunk:
//   vint[l] = exp(a_l) sum_p dy[l, p] (C h_c^T)[l, p]   (the inter output's a share)
//   U = B dst^T;  dw[m] = sum_p x[m, p] U[m, p]         (the chunk state's w share)
//   dx[m, :] = w_m U[m, :] + sum_{l >= m} CB[l, m] exp(a_l - a_m) dt_m dy[l, :]
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) dx_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ acs, const float* __restrict__ cb,
    const float* __restrict__ chunk_h, const float* __restrict__ dst,
    const T* __restrict__ dy, float* __restrict__ vint, float* __restrict__ dwb,
    T* __restrict__ dx, Shape s) {
  __shared__ __align__(16) float As[32][kMaxL];
  __shared__ __align__(16) float Bs[32][64];
  __shared__ float sa[kMaxL], sd[kMaxL];
  const int tid = threadIdx.x, warp = tid / 32;
  const int h = blockIdx.x, bc = blockIdx.y, b = bc / s.NC, c = bc % s.NC;
  const size_t row0 = (size_t)b * s.T + (size_t)c * s.L;
  const size_t hp = (size_t)s.H * s.P;
  const size_t hb = (size_t)bc * s.H + h;
  if (tid < s.L) {
    sa[tid] = acs[hb * s.L + tid];
    sd[tid] = dt[(row0 + tid) * s.H + h];
  }
  const int tx = tid % 8, ty = tid / 8;
  const T* xb = x + (row0 * s.H + h) * s.P;
  const T* dyb = dy + (row0 * s.H + h) * s.P;
  // sum_p src[l, p] acc[l, p] over the row, for the thread's 8 rows
  auto row_dot = [&](const T* src, const float (&acc)[8][8], float (&out)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int l = ty * 8 + i;
      float v = 0.f;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int p = col_of<64, 8>(tx, 4 * g);
        if (l < s.L && p < s.P) {
          const float4 d = load4(src + (size_t)l * hp + p);
          v += d.x * acc[i][4 * g] + d.y * acc[i][4 * g + 1] + d.z * acc[i][4 * g + 2] +
               d.w * acc[i][4 * g + 3];
        }
      }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      out[i] = v;
    }
  };
  float acc[8][8] = {};
  float dots[8];
  // (1) C h_c^T
  const float* hc = chunk_h + hb * s.P * s.S;
  for (int k0 = 0; k0 < s.S; k0 += 32) {
    load_t<kMaxL, 32>(As, Cm + row0 * s.S, s.S, s.L, s.S, k0, One());
    load_t<64, 32>(Bs, hc, s.S, s.P, s.S, k0, One());
    __syncthreads();
    mma_tile<kMaxL, 64, 8, 8, 32>(As, Bs, acc);
    __syncthreads();
  }
  row_dot(dyb, acc, dots);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = ty * 8 + i;
    if (tx == 0 && l < s.L) vint[hb * s.L + l] = expf(sa[l]) * dots[i];
  }
  // (2) B dst^T
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float* gs = dst + hb * s.P * s.S;
  for (int k0 = 0; k0 < s.S; k0 += 32) {
    load_t<kMaxL, 32>(As, Bm + row0 * s.S, s.S, s.L, s.S, k0, One());
    load_t<64, 32>(Bs, gs, s.S, s.P, s.S, k0, One());
    __syncthreads();
    mma_tile<kMaxL, 64, 8, 8, 32>(As, Bs, acc);
    __syncthreads();
  }
  row_dot(xb, acc, dots);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ty * 8 + i;
    if (tx == 0 && m < s.L) dwb[hb * s.L + m] = dots[i];
    const float w = m < s.L ? expf(sa[s.L - 1] - sa[m]) * sd[m] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] *= w;
  }
  // (3) the transposed scores against dy
  const float* cbb = cb + (size_t)bc * s.Lp * s.Lp;
  for (int l0 = 0; l0 < s.L; l0 += 32) {
    const int m = tid;
    if (m < l0 + 32) {  // the rows of the warps that work on this tile
      if (m < s.L) {
        const float am = sa[m], dm = sd[m];
#pragma unroll 8
        for (int k = 0; k < 32; ++k) {
          const int l = l0 + k;
          As[k][m] = (l < s.L && m <= l)
                         ? (cbb[(size_t)l * s.Lp + m] * expf(sa[l] - am)) * dm
                         : 0.f;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 32; ++k) As[k][m] = 0.f;
      }
    }
    load_k<64, 32>(Bs, dyb + (size_t)l0 * hp, hp, s.L - l0, s.P, 0, One());
    __syncthreads();
    if (warp <= l0 / 32) mma_tile<kMaxL, 64, 8, 8, 32>(As, Bs, acc);
    __syncthreads();
  }
  T* dxb = dx + (row0 * s.H + h) * s.P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ty * 8 + i;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int p = col_of<64, 8>(tx, 4 * g);
      if (m < s.L && p < s.P)
        store4(dxb + (size_t)m * hp + p, make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                                     acc[i][4 * g + 2], acc[i][4 * g + 3]));
    }
  }
}

// Per chunk and causal 64x64 tile (l rows, m columns), over the heads:
// dS = dy x^T; q = dS exp(a_l - a_m) masked to m <= l;
//   dcb[l, m] = sum_h q dt_m                      (written once, after the heads)
//   zpart[h, l-tile, m] = sum_l q CB[l, m]        (dt_m's share; a_m's is -dt_m times it)
//   rpart[h, m-tile, l] = sum_m q CB[l, m] dt_m   (a_l's share)
template <typename T>
__global__ void __launch_bounds__(kThreads) dcb_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ acs,
    const float* __restrict__ cb, const T* __restrict__ dy, float* __restrict__ dcb,
    float* __restrict__ zpart, float* __restrict__ rpart, Shape s) {
  __shared__ __align__(16) float As[64][kTile];
  __shared__ __align__(16) float Bs[64][kTile];
  __shared__ float sal[kTile], sam[kTile], sdm[kTile];
  __shared__ float red[kThreads / 32][kTile];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  int it, jt;
  tri(blockIdx.x, it, jt);
  const int bc = blockIdx.y, b = bc / s.NC, c = bc % s.NC;
  const size_t row0 = (size_t)b * s.T + (size_t)c * s.L;
  const size_t hp = (size_t)s.H * s.P;
  const int l0 = it * kTile, m0 = jt * kTile;
  const float* cbb = cb + (size_t)bc * s.Lp * s.Lp;
  float cbv[4][4], dacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = load4(cbb + (size_t)(l0 + ty * 4 + i) * s.Lp + m0 + tx * 4);
    cbv[i][0] = v.x;
    cbv[i][1] = v.y;
    cbv[i][2] = v.z;
    cbv[i][3] = v.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) dacc[i][j] = 0.f;
  }
  for (int h = 0; h < s.H; ++h) {
    const size_t hb = (size_t)bc * s.H + h;
    if (tid < kTile) {
      sal[tid] = l0 + tid < s.L ? acs[hb * s.L + l0 + tid] : 0.f;
    } else if (tid < 2 * kTile) {
      const int r = tid - kTile;
      sam[r] = m0 + r < s.L ? acs[hb * s.L + m0 + r] : 0.f;
    } else if (tid < 3 * kTile) {
      const int r = tid - 2 * kTile;
      sdm[r] = m0 + r < s.L ? dt[(row0 + m0 + r) * s.H + h] : 0.f;
    }
    load_t<kTile, 64>(As, dy + ((row0 + l0) * s.H + h) * s.P, hp, s.L - l0, s.P, 0, One());
    load_t<kTile, 64>(Bs, x + ((row0 + m0) * s.H + h) * s.P, hp, s.L - m0, s.P, 0, One());
    __syncthreads();
    float acc[4][4] = {};
    mma_tile<kTile, kTile, 4, 4, 64>(As, Bs, acc);
    float rs[4] = {}, cs[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int li = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mj = tx * 4 + j;
        if (l0 + li < s.L && m0 + mj <= l0 + li) {
          const float q = acc[i][j] * expf(sal[li] - sam[mj]);
          const float z = q * cbv[i][j];
          dacc[i][j] += q * sdm[mj];
          rs[i] += z * sdm[mj];
          cs[j] += z;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = rs[i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      rs[i] = v;
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rpart[(hb * s.nt + jt) * s.Lp + l0 + ty * 4 + i] = rs[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 16);
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][tx * 4 + j] = cs[j];
    }
    __syncthreads();
    if (tid < kTile) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) v += red[w][tid];
      zpart[(hb * s.nt + it) * s.Lp + m0 + tid] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    store4(dcb + ((size_t)bc * s.Lp + l0 + ty * 4 + i) * s.Lp + m0 + tx * 4,
           make_float4(dacc[i][0], dacc[i][1], dacc[i][2], dacc[i][3]));
}

// dC (blockIdx.y 0) and dB (1), per chunk and 64x64 (row, s) tile:
//   dC[l, s] = sum_{h, p} exp(a_l) dy[l, h, p] h_c[h, p, s] + sum_m dcb[l, m] B[m, s]
//   dB[m, s] = sum_{h, p} w_m x[m, h, p] dst[h, p, s]      + sum_l dcb[l, m] C[l, s]
template <typename T>
__global__ void __launch_bounds__(kThreads) dbc_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ acs, const T* __restrict__ dy,
    const float* __restrict__ chunk_h, const float* __restrict__ dst,
    const float* __restrict__ dcb, T* __restrict__ dB, T* __restrict__ dC, Shape s) {
  __shared__ __align__(16) float As[64][kTile];
  __shared__ __align__(16) float Bs[64][kTile];
  const int nst = (s.S + kTile - 1) / kTile;
  const int ti = blockIdx.x / nst, si = blockIdx.x % nst;
  const bool grad_c = blockIdx.y == 0;
  const int bc = blockIdx.z, b = bc / s.NC, c = bc % s.NC;
  const size_t row0 = (size_t)b * s.T + (size_t)c * s.L;
  const size_t hp = (size_t)s.H * s.P;
  const int r0 = ti * kTile, s0 = si * kTile;
  float acc[4][4] = {};
  for (int h = 0; h < s.H; ++h) {
    const size_t hb = (size_t)bc * s.H + h;
    const float* a = acs + hb * s.L;
    if (grad_c) {
      load_t<kTile, 64>(As, dy + ((row0 + r0) * s.H + h) * s.P, hp, s.L - r0, s.P, 0,
                        [&](int r) { return expf(a[r0 + r]); });
      load_k<kTile, 64>(Bs, chunk_h + hb * s.P * s.S, s.S, s.P, s.S, s0, One());
    } else {
      load_t<kTile, 64>(As, x + ((row0 + r0) * s.H + h) * s.P, hp, s.L - r0, s.P, 0,
                        [&](int r) {
                          return expf(a[s.L - 1] - a[r0 + r]) * dt[(row0 + r0 + r) * s.H + h];
                        });
      load_k<kTile, 64>(Bs, dst + hb * s.P * s.S, s.S, s.P, s.S, s0, One());
    }
    __syncthreads();
    mma_tile<kTile, kTile, 4, 4, 64>(As, Bs, acc);
    __syncthreads();
  }
  const float* dcbb = dcb + (size_t)bc * s.Lp * s.Lp;
  if (grad_c) {
    for (int jt = 0; jt <= ti; ++jt) {
      load_t<kTile, 64>(As, dcbb + (size_t)r0 * s.Lp + jt * kTile, s.Lp, kTile, kTile, 0,
                        One());
      load_k<kTile, 64>(Bs, Bm + (row0 + jt * kTile) * s.S, s.S, s.L - jt * kTile, s.S, s0,
                        One());
      __syncthreads();
      mma_tile<kTile, kTile, 4, 4, 64>(As, Bs, acc);
      __syncthreads();
    }
  } else {
    for (int it = ti; it < s.nt; ++it) {
      load_k<kTile, 64>(As, dcbb + (size_t)it * kTile * s.Lp + r0, s.Lp, kTile, kTile, 0,
                        One());
      load_k<kTile, 64>(Bs, Cm + (row0 + it * kTile) * s.S, s.S, s.L - it * kTile, s.S, s0,
                        One());
      __syncthreads();
      mma_tile<kTile, kTile, 4, 4, 64>(As, Bs, acc);
      __syncthreads();
    }
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T* out = grad_c ? dC : dB;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i, sc = s0 + tx * 4;
    if (r < s.L && sc < s.S)
      store4(out + (row0 + r) * s.S + sc,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// Per chunk and head, thread l: the partial sums gathered into dt's and
// a's gradients, a_end's share added, the reverse cumsum back to dA = dt A:
//   ddt[l] = Z_l + dw_l exp(a_end - a_l) + A g_l,   dA_part = sum_l g_l dt_l,
// g_l = sum_{l' >= l} da_l'.
__global__ void __launch_bounds__(kThreads) final_kernel(
    const float* __restrict__ dt, const float* __restrict__ A, const float* __restrict__ acs,
    const float* __restrict__ zpart, const float* __restrict__ rpart,
    const float* __restrict__ vint, const float* __restrict__ dwb,
    const float* __restrict__ recpart, float* __restrict__ ddt, float* __restrict__ dA_part,
    Shape s) {
  __shared__ float red[2][kThreads / 32];
  __shared__ float tot[kThreads / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, bc = blockIdx.y, b = bc / s.NC, c = bc % s.NC;
  const size_t row0 = (size_t)b * s.T + (size_t)c * s.L;
  const size_t hb = (size_t)bc * s.H + h;
  const int l = tid;
  const bool valid = l < s.L;
  const float aend = acs[hb * s.L + s.L - 1];
  float dtl = 0.f, dw = 0.f, w = 0.f, g_dt = 0.f, da = 0.f;
  if (valid) {
    const float a = acs[hb * s.L + l];
    dtl = dt[(row0 + l) * s.H + h];
    float z = 0.f, r = 0.f;
    for (int i = l / kTile; i < s.nt; ++i) z += zpart[(hb * s.nt + i) * s.Lp + l];
    for (int j = 0; j <= l / kTile; ++j) r += rpart[(hb * s.nt + j) * s.Lp + l];
    dw = dwb[hb * s.L + l];
    const float ew = expf(aend - a);
    w = ew * dtl;
    g_dt = z + dw * ew;
    da = r - dtl * z + vint[hb * s.L + l] - dw * w;
  }
  const float sw = warp_sum(dw * w);
  const float rec = warp_sum(tid < s.nq * 8 ? recpart[hb * s.nq * 8 + tid] : 0.f);
  if (lane == 0) {
    red[0][warp] = sw;
    red[1][warp] = rec;
  }
  __syncthreads();
  float s_w = 0.f, s_rec = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    s_w += red[0][i];
    s_rec += red[1][i];
  }
  if (l == s.L - 1) da += s_w + expf(aend) * s_rec;
  // suffix sum of da over the chunk
  float v = da;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += t;
  }
  if (lane == 0) tot[warp] = v;
  __syncthreads();
  for (int i = warp + 1; i < kThreads / 32; ++i) v += tot[i];
  if (valid) ddt[(row0 + l) * s.H + h] = g_dt + v * A[h];
  const float sa = warp_sum(valid ? v * dtl : 0.f);
  __syncthreads();
  if (lane == 0) red[0][warp] = sa;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) t += red[0][i];
    dA_part[hb] = t;
  }
}

Shape make_shape(int B, int T, int H, int P, int S, int L) {
  Shape s;
  s.B = B;
  s.T = T;
  s.H = H;
  s.P = P;
  s.S = S;
  s.L = L;
  s.NC = T / L;
  s.Lp = (L + kTile - 1) / kTile * kTile;
  s.nt = s.Lp / kTile;
  s.nq = (P * S + 1023) / 1024;
  return s;
}

size_t round64(size_t n) { return (n + 63) / 64 * 64; }

// Workspace layout (floats): acs, cb; the backward adds dcb, zpart, rpart,
// vint, dwb, recpart and the state gradients.
struct Workspace {
  float *acs, *cb, *dcb, *zpart, *rpart, *vint, *dwb, *recpart, *dst;
  size_t total;
  Workspace(const Shape& s, float* base) {
    const size_t bc = (size_t)s.B * s.NC;
    size_t off = 0;
    auto take = [&](size_t n) {
      float* p = base ? base + off : nullptr;
      off += round64(n);
      return p;
    };
    acs = take(bc * s.H * s.L);
    cb = take(bc * s.Lp * s.Lp);
    dcb = take(bc * s.Lp * s.Lp);
    zpart = take(bc * s.H * s.nt * s.Lp);
    rpart = take(bc * s.H * s.nt * s.Lp);
    vint = take(bc * s.H * s.L);
    dwb = take(bc * s.H * s.L);
    recpart = take(bc * s.H * s.nq * 8);
    dst = take(bc * s.H * s.P * s.S);
    total = off;
  }
};

template <typename T>
int ssd_fwd(const T* x, const float* dt, const float* A, const T* Bm, const T* Cm,
            const float* h0, T* y, float* hT, float* chunk_h, float* ws, const Shape& s,
            cudaStream_t st) {
  const Workspace w(s, ws);
  const int bc = s.B * s.NC;
  const int ntri = s.nt * (s.nt + 1) / 2;
  cumsum_kernel<<<bc, 128, 0, st>>>(dt, A, w.acs, s);
  cb_kernel<T><<<dim3(ntri, bc), kThreads, 0, st>>>(Bm, Cm, w.cb, s);
  states_kernel<T><<<dim3(s.H, bc), kThreads, 0, st>>>(x, Bm, dt, w.acs, chunk_h, s, 0);
  fwd_rec_kernel<<<dim3(s.nq, s.B * s.H), kThreads, 0, st>>>(chunk_h, w.acs, h0, hT, s);
  out_kernel<T><<<dim3(s.H, bc), kThreads, 0, st>>>(x, dt, Cm, w.acs, w.cb, chunk_h, y, s);
  return (int)cudaGetLastError();
}

template <typename T>
int ssd_bwd(const T* x, const float* dt, const float* A, const T* Bm, const T* Cm,
            const float* chunk_h, const T* dy, const float* dhT, T* dx, float* ddt,
            float* dA_part, T* dB, T* dC, float* dh0, float* ws, const Shape& s,
            cudaStream_t st) {
  const Workspace w(s, ws);
  const int bc = s.B * s.NC;
  const int ntri = s.nt * (s.nt + 1) / 2;
  const int nst = (s.S + kTile - 1) / kTile;
  cumsum_kernel<<<bc, 128, 0, st>>>(dt, A, w.acs, s);
  cb_kernel<T><<<dim3(ntri, bc), kThreads, 0, st>>>(Bm, Cm, w.cb, s);
  states_kernel<T><<<dim3(s.H, bc), kThreads, 0, st>>>(dy, Cm, dt, w.acs, w.dst, s, 1);
  bwd_rec_kernel<<<dim3(s.nq, s.B * s.H), kThreads, 0, st>>>(w.dst, chunk_h, w.acs, dhT, dh0,
                                                             w.recpart, s);
  dx_kernel<T><<<dim3(s.H, bc), kThreads, 0, st>>>(x, dt, Bm, Cm, w.acs, w.cb, chunk_h, w.dst,
                                                   dy, w.vint, w.dwb, dx, s);
  dcb_kernel<T><<<dim3(ntri, bc), kThreads, 0, st>>>(x, dt, w.acs, w.cb, dy, w.dcb, w.zpart,
                                                     w.rpart, s);
  dbc_kernel<T><<<dim3(s.nt * nst, 2, bc), kThreads, 0, st>>>(x, dt, Bm, Cm, w.acs, dy,
                                                               chunk_h, w.dst, w.dcb, dB, dC, s);
  final_kernel<<<dim3(s.H, bc), kThreads, 0, st>>>(dt, A, w.acs, w.zpart, w.rpart, w.vint,
                                                   w.dwb, w.recpart, ddt, dA_part, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Floats of scratch the forward (backward = 0) or the backward needs.
extern "C" long long repro_ssd_workspace(int B, int T, int H, int P, int S, int L,
                                         int backward) {
  const Shape s = make_shape(B, T, H, P, S, L);
  const Workspace w(s, nullptr);
  return (long long)(backward ? w.total : round64((size_t)B * s.NC * H * L) +
                                              round64((size_t)B * s.NC * s.Lp * s.Lp));
}

// bf16: x, B, C, y are bfloat16 (else float32).  h0 may be null.
extern "C" int repro_ssd_fwd(int bf16, const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, const float* h0, void* y,
                             float* hT, float* chunk_h, float* ws, int B, int T, int H, int P,
                             int S, int L, cudaStream_t st) {
  const Shape s = make_shape(B, T, H, P, S, L);
  if (bf16)
    return ssd_fwd(static_cast<const __nv_bfloat16*>(x), dt, A,
                   static_cast<const __nv_bfloat16*>(Bm), static_cast<const __nv_bfloat16*>(Cm),
                   h0, static_cast<__nv_bfloat16*>(y), hT, chunk_h, ws, s, st);
  return ssd_fwd(static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
                 static_cast<const float*>(Cm), h0, static_cast<float*>(y), hT, chunk_h, ws, s,
                 st);
}

// dhT and dh0 may be null.  dA_part: (B, chunks, H), summed by the caller.
extern "C" int repro_ssd_bwd(int bf16, const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, const float* chunk_h,
                             const void* dy, const float* dhT, void* dx, float* ddt,
                             float* dA_part, void* dB, void* dC, float* dh0, float* ws, int B,
                             int T, int H, int P, int S, int L, cudaStream_t st) {
  const Shape s = make_shape(B, T, H, P, S, L);
  if (bf16) {
    using bf = __nv_bfloat16;
    return ssd_bwd(static_cast<const bf*>(x), dt, A, static_cast<const bf*>(Bm),
                   static_cast<const bf*>(Cm), chunk_h, static_cast<const bf*>(dy), dhT,
                   static_cast<bf*>(dx), ddt, dA_part, static_cast<bf*>(dB),
                   static_cast<bf*>(dC), dh0, ws, s, st);
  }
  return ssd_bwd(static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
                 static_cast<const float*>(Cm), chunk_h, static_cast<const float*>(dy), dhT,
                 static_cast<float*>(dx), ddt, dA_part, static_cast<float*>(dB),
                 static_cast<float*>(dC), dh0, ws, s, st);
}
