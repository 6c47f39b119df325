// MRMC kernel: y = M_v·X·M_vᵀ mod q on a batch of (v, v) states.
//
// Replaces the Pallas kernel `_mrmc_kernel` (repro/kernels/mrmc/mrmc.py,
// launched by `mrmc_pallas`), which runs the product as add chains with
// conditional-subtract reduction on a (v, v, 128-lane) VMEM block.
//
// Layout: lane-major, x[word][col] with cols = lanes · branches (PASTA's
// two branches fold into the column axis, as in the reference wrapper).
// One thread per state; neighbouring threads read neighbouring words, so
// every load and store is coalesced.
//
// Bound: bytes.  Each state is read once and written once (2·v²·4 bytes)
// against 2·v³ small-constant multiply-adds; at v = 8 that is 2 ops per
// byte, far below the card's ops-per-byte balance.  The design keeps the
// state in registers between the two passes, so the device memory traffic
// is the minimum the function needs.  The body is `repro::mrmc_static`
// (mrmc.cuh), built on `repro::mix_dot`, which the fused keystream kernel
// runs with one thread per word (keystream.cu).

#include <cuda_runtime.h>

#include <cstdint>

#include "mrmc.cuh"

namespace {

template <int V>
__global__ void mrmc_kernel(const int32_t* __restrict__ x,
                            int32_t* __restrict__ y, int cols,
                            repro::ModQ m) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  repro::mrmc_static<V>(reinterpret_cast<const uint32_t*>(x) + c, cols,
                        reinterpret_cast<uint32_t*>(y) + c, cols, m);
}

template <int V>
int launch(const int32_t* x, int32_t* y, int cols, repro::ModQ m,
           cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (cols + threads - 1) / threads;
  mrmc_kernel<V><<<blocks, threads, 0, stream>>>(x, y, cols, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_mrmc(int v, const int32_t* x, int32_t* y, int cols,
                          uint32_t q, uint64_t mu, cudaStream_t stream) {
  if (cols <= 0) return 0;
  const repro::ModQ m{q, mu};
  switch (v) {
    case 4: return launch<4>(x, y, cols, m, stream);
    case 6: return launch<6>(x, y, cols, m, stream);
    case 8: return launch<8>(x, y, cols, m, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
