// ELLPACK SpMV, y[r] = sum_k values[k, r] * x[columns[k, r]].
//
// Replaces the Pallas kernel ell_spmv_kernel (src/repro/kernels/
// ell_spmv.py), which sums (8, row_tile) slot tiles into its y row tile
// over a (row_tiles, slot_tiles) grid.
//
// Bound on the H100: bytes (value + int32 column per stored slot, 2 flops).
// Design: one thread per row looping over the K_pad slots.  The arrays are
// slot-major (K_pad, N_pad), so neighbouring threads read neighbouring
// addresses of each slot — coalesced; eight slots' loads are issued before
// their FMAs; x goes through the read-only cache; the sum is fp32 in slot
// order, no atomics.  Offsets are 64-bit (K_pad·N_pad can pass 2^31).
#include "common.cuh"

using namespace rgcsr;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // K_pad is a multiple of 8

template <typename TV, typename TX>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const TV* __restrict__ values, const int* __restrict__ columns,
                const TX* __restrict__ x, TV* __restrict__ y, int k_pad,
                int64_t n_pad) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_pad) return;
  float acc = 0.f;
  for (int k0 = 0; k0 < k_pad; k0 += kUnroll) {
    int col[kUnroll];
    float val[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t off = static_cast<int64_t>(k0 + k) * n_pad + r;
      col[k] = columns[off];
      val[k] = to_float(values[off]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc += val[k] * load_ro(x + col[k]);
  }
  y[r] = from_float<TV>(acc);
}

template <typename TV, typename TX>
int launch(const void* values, const void* columns, const void* x, void* y,
           int k_pad, int64_t n_pad, void* stream) {
  if (n_pad > 0) {
    const unsigned blocks =
        static_cast<unsigned>((n_pad + kThreads - 1) / kThreads);
    ell_spmv_kernel<TV, TX>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const TV*>(values), static_cast<const int*>(columns),
            static_cast<const TX*>(x), static_cast<TV*>(y), k_pad, n_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ELL_SPMV_ENTRY(NAME, TV, TX)                                         \
  extern "C" int NAME(const void* values, const void* columns, const void* x, \
                      void* y, int k_pad, int64_t n_pad, void* stream) {     \
    return launch<TV, TX>(values, columns, x, y, k_pad, n_pad, stream);      \
  }

ELL_SPMV_ENTRY(ell_spmv_f32_f32, float, float)
ELL_SPMV_ENTRY(ell_spmv_f32_bf16, float, __nv_bfloat16)
ELL_SPMV_ENTRY(ell_spmv_bf16_f32, __nv_bfloat16, float)
ELL_SPMV_ENTRY(ell_spmv_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
