// ELLPACK SpMV, y[r] = sum_k values[k, r] * x[columns[k, r]], reading only
// the live slots of each 32-row segment.
//
// Replaces the Pallas kernel ell_spmv_kernel (src/repro/kernels/
// ell_spmv.py), which sums (8, row_tile) slot tiles into its y row tile
// over a (row_tiles, slot_tiles) grid: all K_pad slots, K padded to a
// multiple of 8 for the TPU's tile, padding included.
//
// Bound on the H100: bytes (value + int32 column per slot read, 2 flops;
// tensor cores do not apply).  Design:
// - each warp takes 128 consecutive rows (four 32-row segments) and each
//   thread four consecutive rows, so one slot of a thread's rows is one
//   16-byte column load and one 16-byte (fp32) or 8-byte (bf16) value
//   load, and a warp's slot is 512 contiguous bytes of columns;
// - each lane reads its segment's live-slot count from the plan's
//   seg_slots; the warp loops to the largest of its four counts, the same
//   bound for the whole warp, and each lane predicates its loads, gathers
//   and FMAs by its own segment's count, so no slot past a segment's count
//   is read (those slots are value 0 at column 0: the result differs from
//   the TPU kernel's only where x[0] is not finite).  A segment of count 0
//   writes zeros;
// - slots go in batches of kUnroll, the last one predicated: a batch's
//   column and value loads all go out before its gathers of x, which go
//   through the read-only cache, so a warp keeps a batch of loads in flight.
//   Six slots a batch hold both main-path matrices' 5 live slots in one
//   batch (Raj1's Hybrid ELL runs cold in one wave of CTAs, where each
//   batch costs a trip to memory) at 72 registers; 8 took 96-102 and was
//   1 % slower on fem2d, 4 took two batches and was 1.2-1.6 % slower on
//   Raj1 cold (scripts/torch_k3_variants.py, PERF.md);
// - the sum is fp32 in slot order, one thread per row, no atomics; a
//   thread's four results leave as one store.
// Offsets are 64-bit (K_pad·N_pad can pass 2^31).  N_pad is a multiple of
// 128, so the warps cover it with no tail; the launcher checks that the
// arrays start on 16-byte boundaries.
#include "common.cuh"

using namespace rgcsr;

namespace {

constexpr int kThreads = 128;   // four warps a CTA
constexpr int kRows = 4;        // consecutive rows a thread
constexpr int kUnroll = 6;      // slots a batch
constexpr int kSegment = 32;    // rows one seg_slots count covers
constexpr int kWarpRows = 32 * kRows;

// kN consecutive elements, loaded and stored as one vector.
template <typename T, int kN>
struct alignas(sizeof(T) * kN) Pack {
  T v[kN];
};

template <typename TV, typename TX>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const TV* __restrict__ values, const int* __restrict__ columns,
                const int* __restrict__ seg_slots, const TX* __restrict__ x,
                TV* __restrict__ y, int64_t n_pad) {
  using PV = Pack<TV, kRows>;
  using PC = Pack<int, kRows>;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32 *
      kWarpRows;
  if (first >= n_pad) return;  // the whole warp
  const int64_t r0 = first + threadIdx.x % 32 * kRows;
  const int live = seg_slots[r0 / kSegment];
  const int bound = __reduce_max_sync(0xffffffffu, live);
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < bound; k0 += kUnroll) {
    PC col[kUnroll];
    PV val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < live) {
        const int64_t off = static_cast<int64_t>(k0 + u) * n_pad + r0;
        col[u] = *reinterpret_cast<const PC*>(columns + off);
        val[u] = *reinterpret_cast<const PV*>(values + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < live) {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          acc[j] += to_float(val[u].v[j]) * load_ro(x + col[u].v[j]);
      }
    }
  }
  PV out;
#pragma unroll
  for (int j = 0; j < kRows; ++j) out.v[j] = from_float<TV>(acc[j]);
  *reinterpret_cast<PV*>(y + r0) = out;
}

template <typename TV, typename TX>
int launch(const void* values, const void* columns, const void* seg_slots,
           const void* x, void* y, int64_t n_pad, void* stream) {
  if (n_pad > 0) {
    const int64_t threads = n_pad / kWarpRows * 32;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    ell_spmv_kernel<TV, TX>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const TV*>(values), static_cast<const int*>(columns),
            static_cast<const int*>(seg_slots), static_cast<const TX*>(x),
            static_cast<TV*>(y), n_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ELL_SPMV_ENTRY(NAME, TV, TX)                                        \
  extern "C" int NAME(const void* values, const void* columns,             \
                      const void* seg_slots, const void* x, void* y,       \
                      int64_t n_pad, void* stream) {                       \
    return launch<TV, TX>(values, columns, seg_slots, x, y, n_pad, stream); \
  }

ELL_SPMV_ENTRY(ell_spmv_f32_f32, float, float)
ELL_SPMV_ENTRY(ell_spmv_f32_bf16, float, __nv_bfloat16)
ELL_SPMV_ENTRY(ell_spmv_bf16_f32, __nv_bfloat16, float)
ELL_SPMV_ENTRY(ell_spmv_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
