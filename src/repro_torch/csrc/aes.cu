// AES-128 in counter mode: the producer's XOF.
//
// Replaces the Pallas kernel `_aes_kernel` (repro/kernels/aes/aes.py,
// launched by `aes_ctr_pallas`).  On the TPU the byte-table S-box lookup
// does not vectorise, so that kernel runs SubBytes as a one-hot x table
// matmul on the MXU.  A GPU thread can index a table directly, so here the
// S-box sits in shared memory (loaded once per block) and each thread
// encrypts one 16-byte counter block in registers: SubBytes by lookup,
// ShiftRows as a static relabelling, MixColumns with xtime, AddRoundKey as
// XOR.
//
// Bound: operations.  A block moves 16 bytes out (plus a few bytes of
// counters and round keys that stay in cache) against ~300 32-bit
// operations of table lookups and XORs, so the ALUs and the shared-memory
// lookups, not device memory, set the pace.  Bitslicing or T-tables would
// cut the per-byte operation count; this first version keeps one byte per
// register for clarity.
//
// Two entry points share the round function:
//   repro_aes_ctr  block = nonce12 || be32(counter), one key (the
//                  reference kernel's contract, checked on FIPS-197);
//   repro_aes_xof  block = nonce12[s] || be32(ctr·2^16 + i) for session s
//                  of each lane (repro/crypto/xof.py), round keys gathered
//                  per lane by session id, output packed into
//                  little-endian 32-bit words.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t xtime(uint32_t x) {
  return ((x << 1) & 0xFFu) ^ (((x >> 7) & 1u) * 0x1Bu);
}

// Byte i of round key `rnd` from 44 little-endian packed words.
__device__ __forceinline__ uint32_t rk_byte(const uint32_t* __restrict__ rk,
                                            int rnd, int i) {
  return (__ldg(rk + 4 * rnd + (i >> 2)) >> (8 * (i & 3))) & 0xFFu;
}

// Encrypt one block held as 16 bytes (one per register) in FIPS
// column-major order: byte i is state[row = i % 4][col = i / 4].
__device__ __forceinline__ void aes128_encrypt(uint32_t s[16],
                                               const uint32_t* __restrict__ rk,
                                               const uint8_t* sbox) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] ^= rk_byte(rk, 0, i);
#pragma unroll
  for (int rnd = 1; rnd <= 10; ++rnd) {
    uint32_t t[16];
    // SubBytes + ShiftRows: state[r][c] <- S(state[r][(c + r) % 4])
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) t[4 * c + r] = sbox[s[r + 4 * ((c + r) & 3)]];
    if (rnd < 10) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2],
                       a3 = t[4 * c + 3];
        const uint32_t x0 = xtime(a0), x1 = xtime(a1), x2 = xtime(a2),
                       x3 = xtime(a3);
        t[4 * c] = x0 ^ (x1 ^ a1) ^ a2 ^ a3;
        t[4 * c + 1] = a0 ^ x1 ^ (x2 ^ a2) ^ a3;
        t[4 * c + 2] = a0 ^ a1 ^ x2 ^ (x3 ^ a3);
        t[4 * c + 3] = (x0 ^ a0) ^ a1 ^ a2 ^ x3;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = t[i] ^ rk_byte(rk, rnd, i);
  }
}

__device__ __forceinline__ void load_sbox(uint8_t* sbox,
                                          const uint8_t* __restrict__ src) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) sbox[i] = src[i];
  __syncthreads();
}

__device__ __forceinline__ void set_counter(uint32_t s[16], uint32_t c) {
  s[12] = (c >> 24) & 0xFFu;
  s[13] = (c >> 16) & 0xFFu;
  s[14] = (c >> 8) & 0xFFu;
  s[15] = c & 0xFFu;
}

__global__ void aes_ctr_kernel(const uint8_t* __restrict__ sbox_g,
                               const uint32_t* __restrict__ rk,
                               const uint8_t* __restrict__ nonce12,
                               const int32_t* __restrict__ counters,
                               uint8_t* __restrict__ out, int lanes) {
  __shared__ uint8_t sbox[256];
  load_sbox(sbox, sbox_g);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t s[16];
#pragma unroll
  for (int k = 0; k < 12; ++k) s[k] = __ldg(nonce12 + k);
  set_counter(s, (uint32_t)counters[lane]);
  aes128_encrypt(s, rk, sbox);
  uint8_t* o = out + (size_t)lane * 16;
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = (uint8_t)s[k];
}

__global__ void aes_xof_kernel(const uint8_t* __restrict__ sbox_g,
                               const uint32_t* __restrict__ rk_table,
                               const uint8_t* __restrict__ n12_table,
                               const int32_t* __restrict__ session_ids,
                               const int32_t* __restrict__ block_ctrs,
                               int32_t* __restrict__ out, int lanes,
                               int n_words, int n_blocks) {
  __shared__ uint8_t sbox[256];
  load_sbox(sbox, sbox_g);
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)lanes * n_blocks) return;
  const int lane = (int)(g / n_blocks);
  const int i = (int)(g % n_blocks);
  const int sid = session_ids[lane];
  const uint32_t ctr = (uint32_t)block_ctrs[lane] * 65536u + (uint32_t)i;
  uint32_t s[16];
  const uint8_t* n12 = n12_table + 12 * (size_t)sid;
#pragma unroll
  for (int k = 0; k < 12; ++k) s[k] = __ldg(n12 + k);
  set_counter(s, ctr);
  aes128_encrypt(s, rk_table + 44 * (size_t)sid, sbox);
  int32_t* o = out + (size_t)lane * n_words + 4 * i;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (4 * i + k < n_words) {
      o[k] = (int32_t)(s[4 * k] | (s[4 * k + 1] << 8) | (s[4 * k + 2] << 16) |
                       (s[4 * k + 3] << 24));
    }
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int repro_aes_ctr(const uint8_t* sbox, const uint8_t* round_keys,
                             const uint8_t* nonce12, const int32_t* counters,
                             uint8_t* out, int lanes, cudaStream_t stream) {
  if (lanes <= 0) return 0;
  const int threads = 256;
  const int blocks = (lanes + threads - 1) / threads;
  aes_ctr_kernel<<<blocks, threads, 0, stream>>>(
      sbox, reinterpret_cast<const uint32_t*>(round_keys), nonce12, counters,
      out, lanes);
  return (int)cudaGetLastError();
}

extern "C" int repro_aes_xof(const uint8_t* sbox, const uint8_t* rk_table,
                             const uint8_t* n12_table,
                             const int32_t* session_ids,
                             const int32_t* block_ctrs, int32_t* out,
                             int lanes, int n_words, cudaStream_t stream) {
  if (lanes <= 0 || n_words <= 0) return 0;
  const int n_blocks = (n_words + 3) / 4;
  const long long total = (long long)lanes * n_blocks;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  aes_xof_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      sbox, reinterpret_cast<const uint32_t*>(rk_table), n12_table,
      session_ids, block_ctrs, out, lanes, n_words, n_blocks);
  return (int)cudaGetLastError();
}
