// Helpers shared by the RgCSR / ELLPACK kernels.  Each kernel source is
// compiled into its own shared library, so everything here is inline, a
// template, or, for error_string, defined once per library.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rgcsr {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Read-only (non-coherent) load of a dense-vector element, widened to fp32.
// x is gathered at data-dependent columns and reused across rows, so it goes
// through the read-only data cache (the paper's texture-cache role).
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// The combine of K1 (d = 1) and K2: the sum of a split group's fp32
// partials, rounded once.  Group g's partials are workspace rows first,
// first + 1, …, each G·d floats; element e = lane·d + column of the group
// has partials only in the first ceil(seg_slots[g][lane / 32] / piece_rows)
// of them, the pieces that hold rows of its segment.  One CTA per (split
// group, 32 consecutive elements): thread (i, t) sums partials t, t + 32, …
// of element i, then the 32 sums meet in a fixed tree — one order, so two
// calls agree bit for bit.  Index arithmetic is 32-bit (the launchers keep
// G·d below 2^31) and K1's d = 1 is a template constant, so the divisions
// cost K1 no more than its own combine did.
constexpr int kCombineY = 32;

template <typename TV, bool kScalar>
__global__ void __launch_bounds__(32 * kCombineY)
combine_partials(const float* __restrict__ partial,
                 const int* __restrict__ seg_slots,
                 const int* __restrict__ combine, TV* __restrict__ y,
                 int group_size, int piece_rows, int d_arg) {
  __shared__ float red[kCombineY][33];
  const int d = kScalar ? 1 : d_arg;
  const int per_group = group_size * d;
  const int ctas_per_group = (per_group + 31) / 32;
  const int item = blockIdx.x / ctas_per_group;
  const int e = blockIdx.x % ctas_per_group * 32 + threadIdx.x;
  const int g = combine[2 * item], first = combine[2 * item + 1];
  float acc = 0.f;
  if (e < per_group) {
    const int lane = e / d;
    const int live =
        seg_slots[static_cast<int64_t>(g) * (group_size / 32) + lane / 32];
    const int n = (live + piece_rows - 1) / piece_rows;  // pieces with rows
    const float* p = partial + static_cast<int64_t>(first) * per_group + e;
#pragma unroll 4
    for (int j = threadIdx.y; j < n; j += kCombineY)
      acc += p[static_cast<int64_t>(j) * per_group];
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  for (int half = kCombineY / 2; half > 0; half /= 2) {
    if (threadIdx.y < half)
      red[threadIdx.y][threadIdx.x] += red[threadIdx.y + half][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && e < per_group)
    y[static_cast<int64_t>(g) * per_group + e] =
        from_float<TV>(red[0][threadIdx.x]);
}

// Launch the combine over n_combine split groups (none: nothing launched).
template <typename TV>
int launch_combine(const void* partial, const void* seg_slots,
                   const void* combine, int n_combine, void* y,
                   int group_size, int piece_rows, int d,
                   cudaStream_t stream) {
  if (n_combine > 0) {
    const unsigned ctas =
        static_cast<unsigned>(n_combine) * ((group_size * d + 31) / 32);
    const dim3 block(32, kCombineY);
    const float* part = static_cast<const float*>(partial);
    const int* seg = static_cast<const int*>(seg_slots);
    const int* comb = static_cast<const int*>(combine);
    if (d == 1)
      combine_partials<TV, true><<<ctas, block, 0, stream>>>(
          part, seg, comb, static_cast<TV*>(y), group_size, piece_rows, d);
    else
      combine_partials<TV, false><<<ctas, block, 0, stream>>>(
          part, seg, comb, static_cast<TV*>(y), group_size, piece_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rgcsr

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
