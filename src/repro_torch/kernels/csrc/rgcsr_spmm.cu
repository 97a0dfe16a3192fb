// RgCSR SpMM, Y = A·X with X dense (n_cols, d), for one RgCSRPlan.
//
// Replaces the Pallas kernel rgcsr_spmm_kernel (src/repro/kernels/
// rgcsr_spmm.py), which gathers X[columns2d[k]] as a (G, DT) block per slot
// row k, scales it by values[k] and accumulates into block
// (step_group[s], d_tile) over a (d_tiles, steps) grid.
//
// Bound on the H100: bytes.  Per stored slot the kernel reads 8 bytes of
// matrix and gathers one d-wide row of X (4·d bytes in fp32) for 2·d
// flops: 0.5 flop/byte at most, below the fp32 compute line.  The
// compulsory traffic is the matrix once, X once and Y once; the gathers
// re-read X rows, which the 50 MB L2 absorbs when rows of A share columns.
// Design:
//   * one CTA per (group, d-chunk) of 8 warps; lane = column within the
//     chunk, so each gathered X row segment is one coalesced 32·CPL-wide
//     read per warp and each Y row segment one coalesced write;
//   * the group's rows are taken 128 at a time; warp w owns rows
//     w, w+8, …, w+120 and keeps 16·CPL fp32 accumulators in registers;
//   * eight slot rows of values and columns (the group's lanes) are staged
//     in shared memory per pass, then every warp reads them as broadcasts;
//   * slot rows are summed in order in fp32 — deterministic, no atomics;
//   * the d edge is masked, so X need not be padded to the chunk width;
//   * slot and X offsets are 64-bit.
#include "common.cuh"

using namespace rgcsr;

namespace {

constexpr int kWarps = 8;
constexpr int kRowBlock = 128;
constexpr int kRowsPerWarp = kRowBlock / kWarps;  // 16
constexpr int kStage = 8;  // slot rows staged per pass; rows_per_step % 8 == 0

template <typename TV, typename TX, int CPL>
__global__ void __launch_bounds__(kWarps * 32)
rgcsr_spmm_kernel(const TV* __restrict__ values,
                  const int* __restrict__ columns,
                  const int* __restrict__ group_step_ptr,
                  const TX* __restrict__ X, TV* __restrict__ Y, int group_size,
                  int rows_per_step, int d) {
  __shared__ float s_val[kStage][kRowBlock];
  __shared__ int s_col[kStage][kRowBlock];
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int64_t G = group_size;
  const int c0 = blockIdx.y * (32 * CPL);
  const int64_t s0 = static_cast<int64_t>(group_step_ptr[g]) * rows_per_step;
  const int64_t s1 =
      static_cast<int64_t>(group_step_ptr[g + 1]) * rows_per_step;

  for (int rb = 0; rb < group_size; rb += kRowBlock) {
    float acc[kRowsPerWarp][CPL];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
      for (int q = 0; q < CPL; ++q) acc[j][q] = 0.f;

    for (int64_t s = s0; s < s1; s += kStage) {
      for (int i = tid; i < kStage * kRowBlock; i += kWarps * 32) {
        const int k = i / kRowBlock, l = i % kRowBlock;
        const int64_t off = (s + k) * G + rb + l;
        s_val[k][l] = to_float(values[off]);
        s_col[k][l] = columns[off];
      }
      __syncthreads();
#pragma unroll 2
      for (int k = 0; k < kStage; ++k) {
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int r = warp + kWarps * j;
          const float v = s_val[k][r];
          const TX* xrow = X + static_cast<int64_t>(s_col[k][r]) * d;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const int col = c0 + lane + 32 * q;
            if (col < d) acc[j][q] += v * load_ro(xrow + col);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      TV* yrow = Y + (static_cast<int64_t>(g) * G + rb + warp + kWarps * j) * d;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int col = c0 + lane + 32 * q;
        if (col < d) yrow[col] = from_float<TV>(acc[j][q]);
      }
    }
  }
}

template <typename TV, typename TX, int CPL>
void launch_cpl(const void* values, const void* columns,
                const void* group_step_ptr, const void* X, void* Y,
                int n_groups, int group_size, int rows_per_step, int d,
                cudaStream_t stream) {
  const dim3 grid(n_groups, (d + 32 * CPL - 1) / (32 * CPL));
  const dim3 block(32, kWarps);
  rgcsr_spmm_kernel<TV, TX, CPL><<<grid, block, 0, stream>>>(
      static_cast<const TV*>(values), static_cast<const int*>(columns),
      static_cast<const int*>(group_step_ptr), static_cast<const TX*>(X),
      static_cast<TV*>(Y), group_size, rows_per_step, d);
}

template <typename TV, typename TX>
int launch(const void* values, const void* columns, const void* group_step_ptr,
           const void* X, void* Y, int n_groups, int group_size,
           int rows_per_step, int d, int cols_per_lane, void* stream) {
  if (n_groups > 0 && d > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (cols_per_lane) {
      case 1: launch_cpl<TV, TX, 1>(values, columns, group_step_ptr, X, Y,
                                    n_groups, group_size, rows_per_step, d,
                                    st); break;
      case 2: launch_cpl<TV, TX, 2>(values, columns, group_step_ptr, X, Y,
                                    n_groups, group_size, rows_per_step, d,
                                    st); break;
      case 3: launch_cpl<TV, TX, 3>(values, columns, group_step_ptr, X, Y,
                                    n_groups, group_size, rows_per_step, d,
                                    st); break;
      case 4: launch_cpl<TV, TX, 4>(values, columns, group_step_ptr, X, Y,
                                    n_groups, group_size, rows_per_step, d,
                                    st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RGCSR_SPMM_ENTRY(NAME, TV, TX)                                       \
  extern "C" int NAME(const void* values, const void* columns,              \
                      const void* group_step_ptr, const void* X, void* Y,   \
                      int n_groups, int group_size, int rows_per_step,      \
                      int d, int cols_per_lane, void* stream) {             \
    return launch<TV, TX>(values, columns, group_step_ptr, X, Y, n_groups,  \
                          group_size, rows_per_step, d, cols_per_lane,      \
                          stream);                                          \
  }

RGCSR_SPMM_ENTRY(rgcsr_spmm_f32_f32, float, float)
RGCSR_SPMM_ENTRY(rgcsr_spmm_f32_bf16, float, __nv_bfloat16)
RGCSR_SPMM_ENTRY(rgcsr_spmm_bf16_f32, __nv_bfloat16, float)
RGCSR_SPMM_ENTRY(rgcsr_spmm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
