// RgCSR SpMV, y = A·x, for one RgCSRPlan — the paper's own CUDA shape.
//
// Replaces the Pallas kernel rgcsr_spmv_kernel (src/repro/kernels/
// rgcsr_spmv.py), which walks a step table in grid order and accumulates
// each step's (R, G) slot tile into output block step_group[s].
//
// Bound on the H100: bytes.  Every stored slot is read once (value + int32
// column) and each needs one x element; at 2 flops per slot the kernel does
// about 0.25 flop/byte, far below the ~20 flop/byte where fp32 compute
// would bind.  Design against that bound:
//   * one CTA per group of G rows, one thread per row (lane): slot k of the
//     group is G consecutive values, so every slot read is one coalesced
//     transaction per warp;
//   * the CTA walks its group's slot rows in order, eight at a time with
//     the loads issued before the FMAs so eight gathers are in flight per
//     thread; the sum is in fp32 in slot order — deterministic, no atomics;
//   * x is gathered through the read-only data cache (__ldg); the 50 MB L2
//     holds x for matrices up to ~12M fp32 columns;
//   * the step table of the TPU kernel runs in grid order, which GPU blocks
//     do not have, so the plan carries group_step_ptr (group g owns steps
//     [ptr[g], ptr[g+1])), derived on the host from step_group/step_first;
//   * slot offsets are 64-bit: S·G can pass 2^31.
// The TPU kernel's x column tiling only bounded VMEM; here x is read whole.
#include "common.cuh"

using namespace rgcsr;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;  // rows_per_step is a multiple of 8

template <typename TV, typename TX>
__global__ void __launch_bounds__(kMaxThreads)
rgcsr_spmv_kernel(const TV* __restrict__ values,
                  const int* __restrict__ columns,
                  const int* __restrict__ group_step_ptr,
                  const TX* __restrict__ x, TV* __restrict__ y,
                  int group_size, int rows_per_step) {
  const int g = blockIdx.x;
  const int64_t G = group_size;
  const int64_t s0 = static_cast<int64_t>(group_step_ptr[g]) * rows_per_step;
  const int64_t s1 =
      static_cast<int64_t>(group_step_ptr[g + 1]) * rows_per_step;
  for (int lane = threadIdx.x; lane < group_size; lane += blockDim.x) {
    const TV* v = values + s0 * G + lane;
    const int* c = columns + s0 * G + lane;
    float acc = 0.f;
    for (int64_t s = s0; s < s1; s += kUnroll, v += kUnroll * G,
                 c += kUnroll * G) {
      int col[kUnroll];
      float val[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        col[k] = c[k * G];
        val[k] = to_float(v[k * G]);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) acc += val[k] * load_ro(x + col[k]);
    }
    y[static_cast<int64_t>(g) * G + lane] = from_float<TV>(acc);
  }
}

template <typename TV, typename TX>
int launch(const void* values, const void* columns, const void* group_step_ptr,
           const void* x, void* y, int n_groups, int group_size,
           int rows_per_step, void* stream) {
  if (n_groups > 0) {
    const int threads = group_size < kMaxThreads ? group_size : kMaxThreads;
    rgcsr_spmv_kernel<TV, TX>
        <<<n_groups, threads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const TV*>(values), static_cast<const int*>(columns),
            static_cast<const int*>(group_step_ptr),
            static_cast<const TX*>(x), static_cast<TV*>(y), group_size,
            rows_per_step);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RGCSR_SPMV_ENTRY(NAME, TV, TX)                                       \
  extern "C" int NAME(const void* values, const void* columns,              \
                      const void* group_step_ptr, const void* x, void* y,   \
                      int n_groups, int group_size, int rows_per_step,      \
                      void* stream) {                                       \
    return launch<TV, TX>(values, columns, group_step_ptr, x, y, n_groups,  \
                          group_size, rows_per_step, stream);               \
  }

RGCSR_SPMV_ENTRY(rgcsr_spmv_f32_f32, float, float)
RGCSR_SPMV_ENTRY(rgcsr_spmv_f32_bf16, float, __nv_bfloat16)
RGCSR_SPMV_ENTRY(rgcsr_spmv_bf16_f32, __nv_bfloat16, float)
RGCSR_SPMV_ENTRY(rgcsr_spmv_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
