// RgCSR SpMV, y = A·x, for one RgCSRPlan.
//
// Replaces the Pallas kernel rgcsr_spmv_kernel (src/repro/kernels/
// rgcsr_spmv.py), which walks a step table in grid order and accumulates
// each step's (R, G) slot tile into output block step_group[s]:
//   y[g·G + lane] = Σ_k values2d[k, lane] · x[columns2d[k, lane]]
// over the slot rows k of group g, summed in fp32 and rounded once.
//
// Bound on the H100: bytes.  Each slot read is a value and an int32 column
// for 2 flops (~0.25 flop/byte, far below the ~20 flop/byte where fp32
// compute would bind).  Two things decide how close the kernel comes:
//
// 1. Long groups are split across CTAs.  A group's slot rows can number
//    tens of thousands (Raj1's block plan: four groups of 39,568 slot rows
//    hold 83 % of the plan); one CTA per group would walk them on one SM
//    while the rest of the card idles.  The host cuts every group into
//    pieces of at most P slot rows (RgCSRPlan.work_list), P a multiple of
//    the step R = 8·chunks_per_step, chosen as the plan's total slot rows
//    over 16 CTAs per SM and at least 64 rows (ops._piece_rows), so the
//    grid holds many CTAs per SM whatever the shape and short groups are
//    not split.  Thread-block clusters cannot stand in for the
//    split: a cluster holds at most 16 CTAs, and a 39,568-row group needs
//    hundreds to reach the memory rate.
//      * a group of one piece keeps the direct path: its CTA writes y;
//      * each piece of a longer group writes an fp32 partial row to a
//        workspace, and a second launch, the combine, sums each lane's
//        partials in a fixed tree order and rounds once (the combine of
//        common.cuh, which K2 shares at its d).  The combine is a
//        launch of its own rather than the last-arriving CTA behind an
//        integer ticket: it needs no ticket array to clear before every
//        call (that clear would be one more launch), no __threadfence
//        ordering, and its grid takes the shape its work wants (32 threads
//        per lane) instead of the piece CTA's.  Both launches go out from
//        one entry point, one call of the wrapper.
//    No floating-point atomics: every sum has one order, so two calls give
//    bitwise equal results.
// 2. Trailing padding is not read.  The plan's seg_slots counts, for each
//    32-lane segment (one warp) of each group, the leading slot rows in
//    which some lane holds a real slot; a warp stops there and the loads
//    in flight are masked at the count.  The skipped slots are value
//    0 at column 0, whose term the TPU kernel computes as 0·x[0]: the
//    results differ only where x[0] is not finite.  A piece writes partials
//    only for segments with rows in it, and the combine reads only those
//    (the first ceil(count / P) pieces), so the workspace traffic scales
//    with the live slots.
//
// The work list names the live (piece, segment) units: every segment of a
// one-piece group, and of a split group's pieces only the segments with
// rows in the piece, each a 16-byte record of its first slot row, live
// rows, first lane and destination, so a warp issues its first loads after
// one dependent load.  One warp runs one unit and a CTA packs four, so on
// Raj1 a long piece's one live segment does not hold a CTA of idle warps.
// Within a warp: one thread per row (lane), so every slot row read is one
// coalesced 128-byte transaction per warp; slot rows go in batches of
// eight, and the next batch's value and column loads are issued before
// this batch's x gathers, so sixteen slot rows can be in flight; x is
// gathered through the read-only cache (__ldg), and the 50 MB L2 holds x
// for matrices up to ~12M fp32 columns.
// Slot offsets are 64-bit (S·G can pass 2^31).  The TPU kernel's x column
// tiling only bounded VMEM; here x is read whole.
#include "common.cuh"

using namespace rgcsr;

namespace {

constexpr int kWarps = 4;      // units per CTA, one warp each
constexpr int kUnroll = 8;     // rows_per_step and piece_rows are multiples
constexpr int kSeg = 32;       // lanes per seg_slots segment: one warp

template <typename TV, typename TX>
__global__ void __launch_bounds__(kWarps * 32)
rgcsr_spmv_kernel(const TV* __restrict__ values,
                  const int* __restrict__ columns,
                  const int4* __restrict__ units, int n_units,
                  const TX* __restrict__ x, TV* __restrict__ y,
                  float* __restrict__ partial, int group_size) {
  const int u = blockIdx.x * kWarps + threadIdx.x / kSeg;
  if (u >= n_units) return;
  // first slot row, live slot rows, first lane, destination (see WorkList)
  const int4 w = units[u];
  const int lane = threadIdx.x % kSeg;
  const int64_t G = group_size;
  const TV* v = values + static_cast<int64_t>(w.x) * G + w.z + lane;
  const int* c = columns + static_cast<int64_t>(w.x) * G + w.z + lane;
  const int n = w.y;
  // Eight slot rows per batch; the next batch's loads are issued before
  // this batch's gathers, so the two latencies overlap.
  int col[kUnroll];
  float val[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    col[k] = k < n ? c[k * G] : 0;
    val[k] = k < n ? to_float(v[k * G]) : 0.f;
  }
  float acc = 0.f;
  for (int s = 0; s < n; s += kUnroll) {
    v += kUnroll * G;
    c += kUnroll * G;
    const int m = n - s - kUnroll;  // rows of the next batch
    int next_col[kUnroll];
    float next_val[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      next_col[k] = k < m ? c[k * G] : 0;
      next_val[k] = k < m ? to_float(v[k * G]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (k < n - s) acc += val[k] * load_ro(x + col[k]);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      col[k] = next_col[k];
      val[k] = next_val[k];
    }
  }
  if (w.w >= 0)
    y[static_cast<int64_t>(w.w) + lane] = from_float<TV>(acc);
  else
    partial[static_cast<int64_t>(~w.w) + lane] = acc;
}

template <typename TV, typename TX>
int launch(const void* values, const void* columns, const void* seg_slots,
           const void* units, int n_units, const void* combine, int n_combine,
           const void* x, void* y, void* partial, int group_size,
           int piece_rows, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_units > 0) {
    rgcsr_spmv_kernel<TV, TX>
        <<<(n_units + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
            static_cast<const TV*>(values), static_cast<const int*>(columns),
            static_cast<const int4*>(units), n_units,
            static_cast<const TX*>(x), static_cast<TV*>(y),
            static_cast<float*>(partial), group_size);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the combine of common.cuh at d = 1: 32 threads per lane
  return launch_combine<TV>(partial, seg_slots, combine, n_combine, y,
                            group_size, piece_rows, 1, st);
}

}  // namespace

#define RGCSR_SPMV_ENTRY(NAME, TV, TX)                                        \
  extern "C" int NAME(const void* values, const void* columns,               \
                      const void* seg_slots, const void* units, int n_units, \
                      const void* combine, int n_combine, const void* x,     \
                      void* y, void* partial, int group_size,                \
                      int piece_rows, void* stream) {                        \
    return launch<TV, TX>(values, columns, seg_slots, units, n_units,        \
                          combine, n_combine, x, y, partial, group_size,     \
                          piece_rows, stream);                               \
  }

RGCSR_SPMV_ENTRY(rgcsr_spmv_f32_f32, float, float)
RGCSR_SPMV_ENTRY(rgcsr_spmv_f32_bf16, float, __nv_bfloat16)
RGCSR_SPMV_ENTRY(rgcsr_spmv_bf16_f32, __nv_bfloat16, float)
RGCSR_SPMV_ENTRY(rgcsr_spmv_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
