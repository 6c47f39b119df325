// AES-128 in counter mode: the producer's XOF.
//
// Replaces the Pallas kernel `_aes_kernel` (repro/kernels/aes/aes.py,
// launched by `aes_ctr_pallas`).  On the TPU the byte-table S-box lookup
// does not vectorise, so that kernel runs SubBytes as a one-hot x table
// matmul on the MXU.  A GPU thread can index a table directly.
//
// Bound: operations, the shared-memory lookups.  A pasta-128l window is
// 34.1 M AES blocks against 546 MB of int32 output (0.16 ms of bytes).  A
// block makes 160 table lookups, and an SM serves one conflict-free warp
// lookup (32 words) a clock: 5 clocks a block, 0.65 ms at 1.98 GHz.  Its
// INT32 work is at least one byte extract per lookup plus 84 LOP3-folded
// XORs (244 instructions, 3.8 clocks a block at 64 lanes per SM, 0.50 ms).
//
// Design (T-tables; bitslicing was not tried: it needs 32 blocks per
// thread group and cross-lane ShiftRows/MixColumns, for a gain only where
// the lookups, not the issue slots, bind):
//  * The state is four little-endian 32-bit column words (byte r of word
//    c is state[r][c], the FIPS order), which is also the XOF's output
//    word packing.  A full round is, per column, four lookups in T0..T3
//    (T1 = T0 rotated by 8 bits; T2 and T3 are T0 and T1 rotated by 16, so
//    the column takes one rotate for both), XORs folded by LOP3, and the
//    round key; the last round picks the S-box bytes out of T0 with byte
//    permutes.  T0 is built on the host from the S-box (kernels/aes/ops.py).
//  * The table in shared memory (64 KB) gives each entry 256 bytes: 32
//    replicas of T0[x], one per bank, then 32 of T1[x].  Thread t reads the
//    replica in bank t % 32, so a warp's lookups never conflict, and the
//    byte offset (x << 8) | 4·(t % 32) is one PRMT: no shift, mask or add
//    per lookup.
//  * Work mapping (XOF entry): a thread block of 256 threads works on one
//    lane's AES blocks, or on 256 / n_blocks whole lanes when a lane has
//    fewer blocks (hera-80: 24 blocks, 10 lanes a block).  A thread finds
//    its lane and first block with one 32-bit division, loads its
//    session's 44 round-key words into registers once (uniform loads when
//    the block holds one lane), and strides over the lane's blocks.  Each
//    block goes out as one 16-byte store, so a warp writes 512 contiguous
//    bytes of the lane's row.  Session ids and counters are read as the
//    producer's int64, without a conversion launch.
//
// Registers, shared memory and spills (nvcc -Xptxas -v for sm_90a):
// aes_xof_kernel 76 registers, aes_ctr_kernel 32; both 0
// bytes spilled, no stack frame, 64 KB of dynamic shared memory (the
// table), so three 256-thread blocks fit an SM.
//
// Two entry points share the round function:
//   repro_aes_ctr  block = nonce12 || be32(counter), one key (the
//                  reference kernel's contract, checked on FIPS-197);
//   repro_aes_xof  block = nonce12[s] || be32(ctr·2^16 + i) for session s
//                  of each lane (repro/crypto/xof.py), output packed into
//                  little-endian 32-bit words.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Shared table: 256 entries of 256 bytes.  Entry x holds 32 replicas of
// T0[x] (bytes 0..127) and 32 of T1[x] (bytes 128..255); thread t reads
// the replica in bank t % 32, so a warp's lookups never conflict.
constexpr int kTableBytes = 256 * 256;

// Fill the table from the 256-word T0, four equal words per 16-byte
// store, and wait for it.
__device__ __forceinline__ void load_table(uint32_t* tab,
                                           const uint32_t* __restrict__ t0) {
  for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x) {
    const uint32_t v = __ldg(t0 + (i >> 4));  // entry x = word / 64
    const uint32_t e = (i & 8) ? __funnelshift_l(v, v, 8) : v;  // T1 half
    reinterpret_cast<uint4*>(tab)[i] = make_uint4(e, e, e, e);
  }
  __syncthreads();
}

// Byte offset of entry (byte k of w) in this thread's bank: one PRMT puts
// byte k of w in bits 8..15 over `boff` = 4·(t % 32) (whose upper bytes
// are zero).
template <int K>
__device__ __forceinline__ uint32_t entry(uint32_t w, uint32_t boff) {
  return __byte_perm(w, boff, 0x5504 | (K << 4));
}

__device__ __forceinline__ uint32_t lds(const char* tab, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(tab + off);
}

// One full round on column c: bytes r of columns c + r (ShiftRows) through
// T0..T3 (MixColumns folded in), then the round key.  T2 and T3 are T0 and
// T1 rotated by 16, so one rotate serves both.
__device__ __forceinline__ uint32_t round_col(const char* tab, uint32_t boff,
                                              uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d,
                                              uint32_t k) {
  const uint32_t hi = lds(tab, entry<2>(c, boff)) ^
                      lds(tab + 128, entry<3>(d, boff));
  return lds(tab, entry<0>(a, boff)) ^ lds(tab + 128, entry<1>(b, boff)) ^
         __funnelshift_l(hi, hi, 16) ^ k;
}

// Last round (no MixColumns): S(x) is byte 1 and byte 2 of T0[x].
__device__ __forceinline__ uint32_t last_col(const char* tab, uint32_t boff,
                                             uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d,
                                             uint32_t k) {
  const uint32_t lo = __byte_perm(lds(tab, entry<0>(a, boff)),
                                  lds(tab, entry<1>(b, boff)), 0x0051);
  const uint32_t hi = __byte_perm(lds(tab, entry<2>(c, boff)),
                                  lds(tab, entry<3>(d, boff)), 0x6200);
  return __byte_perm(lo, hi, 0x7610) ^ k;
}

// Encrypt the block held as column words s[0..3] in place.
__device__ __forceinline__ void aes128_encrypt(uint32_t s[4],
                                               const uint32_t rk[44],
                                               const char* tab,
                                               uint32_t boff) {
  uint32_t a = s[0] ^ rk[0], b = s[1] ^ rk[1], c = s[2] ^ rk[2],
           d = s[3] ^ rk[3];
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    const uint32_t a2 = round_col(tab, boff, a, b, c, d, rk[4 * r]);
    const uint32_t b2 = round_col(tab, boff, b, c, d, a, rk[4 * r + 1]);
    const uint32_t c2 = round_col(tab, boff, c, d, a, b, rk[4 * r + 2]);
    const uint32_t d2 = round_col(tab, boff, d, a, b, c, rk[4 * r + 3]);
    a = a2;
    b = b2;
    c = c2;
    d = d2;
  }
  s[0] = last_col(tab, boff, a, b, c, d, rk[40]);
  s[1] = last_col(tab, boff, b, c, d, a, rk[41]);
  s[2] = last_col(tab, boff, c, d, a, b, rk[42]);
  s[3] = last_col(tab, boff, d, a, b, c, rk[43]);
}

// Column words of nonce12 (bytes 0..11, little-endian within each word).
__device__ __forceinline__ void load_prefix(uint32_t s[4],
                                            const uint8_t* __restrict__ n12) {
#pragma unroll
  for (int w = 0; w < 3; ++w)
    s[w] = (uint32_t)__ldg(n12 + 4 * w) |
           ((uint32_t)__ldg(n12 + 4 * w + 1) << 8) |
           ((uint32_t)__ldg(n12 + 4 * w + 2) << 16) |
           ((uint32_t)__ldg(n12 + 4 * w + 3) << 24);
}

__device__ __forceinline__ void load_keys(uint32_t rk[44],
                                          const uint32_t* __restrict__ src) {
#pragma unroll
  for (int i = 0; i < 44; ++i) rk[i] = __ldg(src + i);
}

// Column word 3 = bytes 12..15 = be32(ctr).
__device__ __forceinline__ uint32_t be32_word(uint32_t ctr) {
  return __byte_perm(ctr, 0, 0x0123);
}

__global__ void __launch_bounds__(kThreads)
aes_ctr_kernel(const uint32_t* __restrict__ t0,
               const uint32_t* __restrict__ round_keys,
               const uint8_t* __restrict__ nonce12,
               const int64_t* __restrict__ counters, uint8_t* __restrict__ out,
               int lanes) {
  extern __shared__ __align__(16) uint32_t tab_smem[];
  load_table(tab_smem, t0);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const char* tab = reinterpret_cast<const char*>(tab_smem);
  const uint32_t boff = 4 * (threadIdx.x & 31);
  uint32_t rk[44];
  load_keys(rk, round_keys);
  uint32_t s[4];
  load_prefix(s, nonce12);
  s[3] = be32_word((uint32_t)counters[lane]);
  aes128_encrypt(s, rk, tab, boff);
  reinterpret_cast<uint4*>(out)[lane] = make_uint4(s[0], s[1], s[2], s[3]);
}

__global__ void __launch_bounds__(kThreads)
aes_xof_kernel(const uint32_t* __restrict__ t0,
               const uint32_t* __restrict__ rk_table,
               const uint8_t* __restrict__ n12_table,
               const int64_t* __restrict__ session_ids,
               const int64_t* __restrict__ block_ctrs,
               int32_t* __restrict__ out, int lanes, int n_words,
               int n_blocks, int group) {
  extern __shared__ __align__(16) uint32_t tab_smem[];
  load_table(tab_smem, t0);
  const int sub = threadIdx.x / n_blocks;  // lane within the block's group
  const int lane = blockIdx.x * group + sub;
  if (sub >= group || lane >= lanes) return;
  const char* tab = reinterpret_cast<const char*>(tab_smem);
  const uint32_t boff = 4 * (threadIdx.x & 31);
  const int sid = (int)session_ids[lane];
  uint32_t rk[44];
  load_keys(rk, rk_table + 44 * (size_t)sid);
  uint32_t prefix[4];
  load_prefix(prefix, n12_table + 12 * (size_t)sid);
  const uint32_t base = (uint32_t)block_ctrs[lane] * 65536u;
  int32_t* row = out + (size_t)lane * n_words;
  const bool vec = (n_words & 3) == 0;
  for (int i = threadIdx.x - sub * n_blocks; i < n_blocks; i += kThreads) {
    uint32_t s[4] = {prefix[0], prefix[1], prefix[2],
                     be32_word(base + (uint32_t)i)};
    aes128_encrypt(s, rk, tab, boff);
    if (vec) {
      reinterpret_cast<uint4*>(row)[i] = make_uint4(s[0], s[1], s[2], s[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * i + k < n_words) row[4 * i + k] = (int32_t)s[k];
    }
  }
}

// Allow the 64 KB table as dynamic shared memory.  Set before every launch:
// the attribute holds for the device current when it is set, and a host
// call costs far less than the launch.
template <typename K>
int allow_table(K kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int repro_aes_ctr(const uint32_t* t0, const uint8_t* round_keys,
                             const uint8_t* nonce12, const int64_t* counters,
                             uint8_t* out, int lanes, cudaStream_t stream) {
  if (lanes <= 0) return 0;
  const int allowed = allow_table(aes_ctr_kernel);
  if (allowed != 0) return allowed;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  aes_ctr_kernel<<<blocks, kThreads, kTableBytes, stream>>>(
      t0, reinterpret_cast<const uint32_t*>(round_keys), nonce12, counters,
      out, lanes);
  return (int)cudaGetLastError();
}

// Thread blocks: one per lane when a lane has >= 256 AES blocks, else one
// per `group` = 256 / n_blocks lanes (kernels/aes/ops.py xof_launch_shape
// computes the same).
extern "C" int repro_aes_xof(const uint32_t* t0, const uint8_t* rk_table,
                             const uint8_t* n12_table,
                             const int64_t* session_ids,
                             const int64_t* block_ctrs, int32_t* out,
                             int lanes, int n_words, cudaStream_t stream) {
  if (lanes <= 0 || n_words <= 0) return 0;
  const int n_blocks = (n_words + 3) / 4;
  const int group = n_blocks >= kThreads ? 1 : kThreads / n_blocks;
  const int blocks = (lanes + group - 1) / group;
  const int allowed = allow_table(aes_xof_kernel);
  if (allowed != 0) return allowed;
  aes_xof_kernel<<<blocks, kThreads, kTableBytes, stream>>>(
      t0, reinterpret_cast<const uint32_t*>(rk_table), n12_table,
      session_ids, block_ctrs, out, lanes, n_words, n_blocks, group);
  return (int)cudaGetLastError();
}
