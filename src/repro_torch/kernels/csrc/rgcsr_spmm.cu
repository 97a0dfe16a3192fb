// RgCSR SpMM, Y = A·X with X dense (n_cols, d), for one RgCSRPlan.
//
// Replaces the Pallas kernel rgcsr_spmm_kernel (src/repro/kernels/
// rgcsr_spmm.py), which gathers X[columns2d[k]] as a (G, DT) block per slot
// row k, scales it by values[k] and accumulates into block
// (step_group[s], d_tile) over a (d_tiles, steps) grid:
//   Y[g·G + lane, :] = Σ_k values2d[k, lane] · X[columns2d[k, lane], :]
// over the slot rows k of group g, summed in fp32 and rounded once.
//
// Bound on the H100: bytes.  Per live slot the kernel reads 8 bytes of
// matrix and gathers one d-wide row of X (4·d bytes in fp32) for 2·d
// flops: 0.5 flop/byte at most, below the fp32 compute line.  The
// compulsory traffic is the live slots once, X once and Y once; the
// gathers re-read X rows, which the 50 MB L2 absorbs when rows of A share
// columns.  Design:
//   * long groups are split across CTAs exactly as in K1 (see
//     rgcsr_spmv.cu), with the piece size P from the same rule, here also
//     doubled until the fp32 partial workspace (pieces of split groups ×
//     G × d × 4 B) fits in 64 MiB.  A group of one piece writes Y
//     directly; the pieces of a longer group write partials and a last
//     launch, the combine of common.cuh (K1's at d = 1), sums each (row,
//     column)'s partials in a fixed tree order and rounds once.  No
//     atomics: bitwise repeatable;
//   * one CTA of eight warps per (piece, d-chunk), from the work list's
//     tiles: the piece's first slot row, its destination, and the live
//     slot rows of each 32-lane segment in it (from seg_slots);
//   * lanes run along d: each gathered X row segment is one coalesced
//     32·CPL-wide read per warp and each Y row segment one coalesced
//     write; the d edge is masked, so X need not be padded;
//   * the group's rows are taken 128 at a time; warp w owns rows w, w+8,
//     …, w+120 (four in each segment) and keeps 16·CPL fp32 accumulators.
//     A group may be any multiple of 32 lanes (a tensor-parallel rank's
//     lane slice, G/n): the segments past its last lane count no live
//     slot rows, stage zeros and write nothing;
//   * eight slot rows of values and columns are staged in shared memory per
//     stage with cp.async (16-byte copies, one of each per thread).  A
//     second buffer, loading the next stage while the warps consume this
//     one, was measured slower on both fem2d and Raj1 and is not kept.
//     Padding is skipped at two grains, both uniform across the CTA: a
//     segment's slot rows past its live count are never read from memory
//     (zeros are written to shared memory instead), and no slot row past
//     the row block's last live row is staged or computed on;
//   * two loops over the staged slot rows, one launch each; the work list
//     puts the tiles of one-piece groups first, so the choice is uniform
//     across a launch and neither loop's registers weigh on the other:
//       - one-piece groups (all of fem2d): for each staged slot row a warp
//         issues the X gathers of its 16 rows together, then their FMAs
//         (sixteen gathers in flight); padding inside the live rows is
//         summed as 0·X[0], as the TPU kernel does.  A branch around each
//         of these gathers kept the compiler from issuing the sixteen
//         together, which cost far more on fem2d than the L1 hits on X[0]
//         it saved;
//       - pieces of split groups (Raj1's long rows: one real row in 128):
//         a warp takes its rows one at a time, skips a row whose staged
//         slot rows are all padding — warp-uniform, since the whole warp
//         reads one row — and issues a live row's eight gathers together;
//     the skipped slots change the result only where X[0] is not finite;
//   * slot and X offsets are 64-bit.
#include <cuda_pipeline.h>

#include "common.cuh"

using namespace rgcsr;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowBlock = 128;
constexpr int kRowsPerWarp = kRowBlock / kWarps;  // 16
constexpr int kSeg = 32;                          // lanes of one segment
constexpr int kSegsPerBlock = kRowBlock / kSeg;   // 4
constexpr int kRowsPerSeg = kSeg / kWarps;        // a warp's rows per segment
constexpr int kStage = 8;   // slot rows per stage; rows_per_step % 8 == 0

template <typename TV, typename TX, int CPL, bool kSplit>
__global__ void __launch_bounds__(kThreads)
rgcsr_spmm_kernel(const TV* __restrict__ values,
                  const int* __restrict__ columns,
                  const int* __restrict__ tiles, const TX* __restrict__ X,
                  TV* __restrict__ Y, float* __restrict__ partial,
                  int group_size, int d) {
  constexpr int kValsPerCopy = 16 / sizeof(TV);
  constexpr int kValCopies = kStage * kRowBlock / kValsPerCopy;
  constexpr int kColCopies = kStage * kRowBlock / 4;
  static_assert(kValCopies <= kThreads && kColCopies <= kThreads,
                "one 16-byte copy of values and one of columns per thread");
  __shared__ __align__(16) TV s_val[kStage][kRowBlock];
  __shared__ __align__(16) int s_col[kStage][kRowBlock];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int64_t G = group_size;
  // first slot row, destination, live slot rows of each segment
  const int* tile = tiles + static_cast<int64_t>(blockIdx.x) *
                                (2 + group_size / kSeg);
  const int64_t row0 = tile[0];
  const int dst = tile[1];  // g·G, or ~(part·G) for a partial
  const int c0 = blockIdx.y * (32 * CPL);
  // This thread's 16-byte copies of each stage: slot row and first lane.
  const int vk = tid / (kRowBlock / kValsPerCopy);
  const int vl = tid % (kRowBlock / kValsPerCopy) * kValsPerCopy;
  const int ck = tid / (kRowBlock / 4);
  const int cl = tid % (kRowBlock / 4) * 4;

  for (int rb = 0; rb < group_size; rb += kRowBlock) {
    // Segments of this row block: 4, or fewer in the last block of a group
    // that is not a multiple of 128 lanes (a rank's lane slice, G/n).
    const int n_seg = min(kSegsPerBlock, (group_size - rb) / kSeg);
    // Slot rows with anything but padding: per segment, and n for the block.
    int live[kSegsPerBlock];
    int n = 0, v_live = 0, c_live = 0;
#pragma unroll
    for (int i = 0; i < kSegsPerBlock; ++i) {
      live[i] = i < n_seg ? tile[2 + rb / kSeg + i] : 0;
      n = max(n, live[i]);
      if (vl / kSeg == i) v_live = live[i];
      if (cl / kSeg == i) c_live = live[i];
    }
    const int n_stages = (n + kStage - 1) / kStage;
    const TV* vsrc = values + row0 * G + rb + vl + vk * G;
    const int* csrc = columns + row0 * G + rb + cl + ck * G;
    float acc[kRowsPerWarp][CPL];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
      for (int q = 0; q < CPL; ++q) acc[j][q] = 0.f;

    for (int st = 0; st < n_stages; ++st) {
      const int s = st * kStage;
      // Stage slot rows [s, s + 8): a segment's rows before its count are
      // copied, its rows from there to n are zeros (never read from
      // memory), rows from n on are not touched (never computed on).
      if (tid < kValCopies) {
        if (s + vk < v_live)
          __pipeline_memcpy_async(&s_val[vk][vl], vsrc + s * G, 16);
        else if (s + vk < n)
          *reinterpret_cast<int4*>(&s_val[vk][vl]) = make_int4(0, 0, 0, 0);
      }
      if (s + ck < c_live)
        __pipeline_memcpy_async(&s_col[ck][cl], csrc + s * G, 16);
      else if (s + ck < n)
        *reinterpret_cast<int4*>(&s_col[ck][cl]) = make_int4(0, 0, 0, 0);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      const int k_end = min(kStage, n - s);
      if constexpr (!kSplit) {
        // Slot row outer, up to the block's last live row (CTA-uniform): a
        // warp's 16 rows' gathers are issued together, then their FMAs.
#pragma unroll 2
        for (int k = 0; k < k_end; ++k) {
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j) {
            const int r = warp + kWarps * j;
            const float v = to_float(s_val[k][r]);
            const TX* xrow = X + static_cast<int64_t>(s_col[k][r]) * d;
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              const int col = c0 + lane + 32 * q;
              if (col < d) acc[j][q] += v * load_ro(xrow + col);
            }
          }
        }
      } else {
        // Row outer: a warp skips a row whose staged slot rows are all
        // padding (the warp works on one row at a time, so the branch does
        // not diverge) and gathers a live row's slot rows together.
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int r = warp + kWarps * j;
          if (live[j / kRowsPerSeg] <= s) continue;
          const int kl = lane % kStage;
          const bool real = lane < k_end && (to_float(s_val[kl][r]) != 0.f ||
                                             s_col[kl][r] != 0);
          if (!__any_sync(0xffffffffu, real)) continue;
#pragma unroll
          for (int k = 0; k < kStage; ++k) {
            const float v = k < k_end ? to_float(s_val[k][r]) : 0.f;
            const TX* xrow =
                X + static_cast<int64_t>(k < k_end ? s_col[k][r] : 0) * d;
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              const int col = c0 + lane + 32 * q;
              if (col < d) acc[j][q] += v * load_ro(xrow + col);
            }
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      if (j / kRowsPerSeg >= n_seg) continue;  // past the group's lanes
      const int64_t row = rb + warp + kWarps * j;
      TV* out = dst >= 0 ? Y + (dst + row) * d : nullptr;
      float* out_part = dst < 0 && live[j / kRowsPerSeg] > 0
                            ? partial + (~dst + row) * d
                            : nullptr;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int col = c0 + lane + 32 * q;
        if (col >= d) continue;
        if (out) out[col] = from_float<TV>(acc[j][q]);
        if (out_part) out_part[col] = acc[j][q];
      }
    }
  }
}

struct Args {
  const void *values, *columns, *seg_slots, *tiles;
  int n_tiles, n_direct;
  const void* combine;
  int n_combine;
  const void* X;
  void *Y, *partial;
  int group_size, piece_rows, d;
  cudaStream_t stream;
};

// The direct tiles (the work list puts them first) and the split tiles go
// out as two launches of the two loops.
template <typename TV, typename TX, int CPL>
int launch_cpl(const Args& a) {
  const int d_chunks = (a.d + 32 * CPL - 1) / (32 * CPL);
  const int* tiles = static_cast<const int*>(a.tiles);
  const int64_t stride = 2 + a.group_size / kSeg;
  const int n_split = a.n_tiles - a.n_direct;
  if (a.n_direct > 0) {
    rgcsr_spmm_kernel<TV, TX, CPL, false>
        <<<dim3(a.n_direct, d_chunks), dim3(32, kWarps), 0, a.stream>>>(
            static_cast<const TV*>(a.values),
            static_cast<const int*>(a.columns), tiles,
            static_cast<const TX*>(a.X), static_cast<TV*>(a.Y),
            static_cast<float*>(a.partial), a.group_size, a.d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_split > 0) {
    rgcsr_spmm_kernel<TV, TX, CPL, true>
        <<<dim3(n_split, d_chunks), dim3(32, kWarps), 0, a.stream>>>(
            static_cast<const TV*>(a.values),
            static_cast<const int*>(a.columns), tiles + a.n_direct * stride,
            static_cast<const TX*>(a.X), static_cast<TV*>(a.Y),
            static_cast<float*>(a.partial), a.group_size, a.d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TV, typename TX>
int launch(const Args& a, int cols_per_lane) {
  if (a.n_tiles <= 0 || a.d <= 0) return static_cast<int>(cudaGetLastError());
  int err;
  switch (cols_per_lane) {
    case 1: err = launch_cpl<TV, TX, 1>(a); break;
    case 2: err = launch_cpl<TV, TX, 2>(a); break;
    case 3: err = launch_cpl<TV, TX, 3>(a); break;
    case 4: err = launch_cpl<TV, TX, 4>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  // the combine of common.cuh: 32 threads per (row, column) element
  return launch_combine<TV>(a.partial, a.seg_slots, a.combine, a.n_combine,
                            a.Y, a.group_size, a.piece_rows, a.d, a.stream);
}

}  // namespace

#define RGCSR_SPMM_ENTRY(NAME, TV, TX)                                        \
  extern "C" int NAME(const void* values, const void* columns,               \
                      const void* seg_slots, const void* tiles, int n_tiles, \
                      int n_direct, const void* combine, int n_combine,      \
                      const void* X, void* Y, void* partial, int group_size, \
                      int piece_rows, int d, int cols_per_lane,              \
                      void* stream) {                                        \
    const Args a{values,    columns,   seg_slots,  tiles,                    \
                 n_tiles,   n_direct,  combine,    n_combine,                \
                 X,         Y,         partial,    group_size,               \
                 piece_rows, d,        static_cast<cudaStream_t>(stream)};   \
    return launch<TV, TX>(a, cols_per_lane);                                 \
  }

RGCSR_SPMM_ENTRY(rgcsr_spmm_f32_f32, float, float)
RGCSR_SPMM_ENTRY(rgcsr_spmm_f32_bf16, float, __nv_bfloat16)
RGCSR_SPMM_ENTRY(rgcsr_spmm_bf16_f32, __nv_bfloat16, float)
RGCSR_SPMM_ENTRY(rgcsr_spmm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
