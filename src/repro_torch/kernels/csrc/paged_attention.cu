// Paged GQA decode attention: one query token per slot against the slot's
// live keys and values, read in place from the page pool through its block
// table.
//
// Replaces no TPU kernel: the JAX package decodes from a paged cache in
// plain jnp, gathering every slot's whole table (pages_per_slot ·
// page_size rows) into a dense view and masking the positions past the
// slot's length.  On the card that chain gathered and upcast the whole
// pool at every layer of every decode step, and ran float32 attention over
// max_seq positions of which a slot holds a few hundred.
//
// Bound on the H100: bytes.  Each live K and V row is read once
// (D · store bytes each) for 2 · G · D flops apiece, G query heads a kv
// head; a decode step's live rows are a few GB at 3.35 TB/s.  Design:
// - work cut by length on the card: a slot's live rows go in parts of
//   part_pages whole pages, one CTA per (kv head, slot, part), kv heads
//   fastest so that a long slot's heads land on different SMs.  The grid
//   is fixed by (B, Hkv, pages / part_pages), so a graph replays it at
//   any length: a CTA past its slot's last part exits at once, and no
//   page past a slot's live length is read.  One CTA streaming a whole
//   long slot was bound by its chain of tile round trips: a first design,
//   one CTA per (kv head, slot), read chat's 64 slots at 14 % of this
//   bound, the longest slot setting the time;
// - the G query heads of a kv head share each K and V row: a row is read
//   from memory once per CTA, not once per query head;
// - rows are staged in shared memory a tile at a time with 16-byte
//   cp.async copies (rows looked up one by one through the block table, so
//   a tile may span pages), the next tile in flight while one is consumed;
//   a score step dots four query heads at once, so their shuffle sums
//   interleave.  Past this the kernel is bound by its instructions, not
//   by memory: a ring of three tiles, and unrolled loops, measured no
//   faster;
// - scores: L lanes a row (L the power of two covering D / 8 chunks of 8
//   elements), each lane one 16-byte chunk of K dotted with each query
//   head (q kept in shared memory as fp32), summed over the L lanes by xor
//   shuffles; the part's logits stay in shared memory (rows · G · 4
//   bytes);
// - softmax as attend() takes it: logits, max and sum in fp32, each
//   probability normalised in fp32 and rounded to the value dtype, then
//   P · V accumulated in fp32 by (query head, 8-column chunk) pairs over
//   row groups and rounded once.  A stored K or V element is first rounded
//   to the value dtype, as the cache's load to the compute dtype does;
// - three launches.  (1) Each CTA scores its part.  A slot of one part is
//   finished there (softmax, P · V, the output); a longer one leaves each
//   part's fp32 logits and (max, sum) in scratch.  (2) Each part of a
//   longer slot combines every part's (max, sum), normalises its logits
//   and writes its fp32 share of P · V.  (3) The shares are summed in
//   part order and rounded once.  K and V are read once each;
//   the logits travel through scratch (L2) instead of K twice.  Sums run
//   in a fixed order everywhere: two calls agree bit for bit.
// The kernel allocates nothing and never syncs with the host; the launcher
// allocates the output and the fp32 scratch.
#include "common.cuh"

#include <cuda_fp16.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;        // four warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;            // elements of D one lane owns
constexpr int kMaxPairs = 4;         // (head, chunk) pairs a thread sums
constexpr int kHeadBatch = 4;        // query heads a score step dots at once
constexpr int kStages = 2;           // tiles of the ring in shared memory
constexpr int kMaxSmem = 227 * 1024;

enum Mode { kScore = 0, kShare = 1 };

struct Args {
  const void* q;             // (B, 1, Hkv·G, D) value dtype
  const void* k;             // (n_pages, page_size, Hkv, D) store dtype
  const void* v;
  const int* block_table;    // (B, pages)
  const int* index;          // (B,) tokens written before this step's
  void* out;                 // (B, 1, Hkv·G, D) value dtype
  float* logits;             // (B, Hkv, parts, part rows, G)
  float* stats;              // (parts, B, Hkv·G, 2) max, sum
  float* share;              // (parts, B, Hkv·G, D)
  int batch, hkv, group, dim, page_size, pages, part_pages, tile_rows;
  float scale;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

// x as the value dtype O holds it, widened to fp32.
template <typename O>
__device__ __forceinline__ float round_to(float x) {
  return widen(narrow<O>(x));
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// kChunk consecutive stored elements (16-byte aligned) as the value dtype O
// holds them, widened to fp32.
template <typename S, typename O>
__device__ __forceinline__ void load_chunk(const S* p, float (&x)[kChunk]) {
  using V = Vec<S>;
#pragma unroll
  for (int i = 0; i < kChunk / V::kN; ++i) {
    const V vec = reinterpret_cast<const V*>(p)[i];
#pragma unroll
    for (int j = 0; j < V::kN; ++j) {
      if constexpr (std::is_same_v<S, O>)
        x[i * V::kN + j] = widen(vec.v[j]);
      else
        x[i * V::kN + j] = round_to<O>(widen(vec.v[j]));
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most kStages - 1 groups of this thread's copies are in
// flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of one CTA: q (G·D fp32), the (max, sum) of each head, the
// ring of kStages tiles of rows, the logits of the part's rows.  The
// kernel and the launcher lay it out with these two functions.
__host__ __device__ __forceinline__ size_t tiles_offset(int g, int d) {
  return align16(static_cast<size_t>(g) * (d + 2) * sizeof(float));
}
__host__ __device__ __forceinline__ size_t logits_offset(int g, int d,
                                                         int tile_rows,
                                                         size_t store) {
  return tiles_offset(g, d) +
         align16(kStages * static_cast<size_t>(tile_rows) * d * store);
}

// Where slot b's rows lie: its live length and how many parts hold them.
struct Slot {
  int len, parts;
};
__device__ __forceinline__ Slot slot_of(const Args& a, int b) {
  const int len = min(a.index[b] + 1, a.pages * a.page_size);
  const int live_pages = (len + a.page_size - 1) / a.page_size;
  return {len, (live_pages + a.part_pages - 1) / a.part_pages};
}

// kPairs: the (head, chunk) pairs of P · V one thread sums, 1 where
// G · D / 8 <= kThreads (the registers of the others unspent).
template <typename S, typename O, int kPairs>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Args a, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y, part = blockIdx.z;
  const Slot slot = slot_of(a, b);
  // launch 1: every live part; launch 2: the parts of multi-part slots
  if (part >= slot.parts || (mode == kShare && slot.parts == 1)) return;

  const int G = a.group, D = a.dim, ps = a.page_size;
  const int hq = a.hkv * G;
  const int64_t head0 = static_cast<int64_t>(b) * hq + h * G;  // (b, h·G)
  const int part_rows = a.part_pages * ps;
  const int lo = part * part_rows;
  const int hi = min(lo + part_rows, slot.len);
  const int n = hi - lo;
  const int64_t slab = static_cast<int64_t>(a.batch) * hq;  // heads a part
  const int n_parts = gridDim.z;
  // this CTA's logits in scratch: (rows, G) of its part
  float* lg_out = a.logits +
                  ((static_cast<int64_t>(b) * a.hkv + h) * n_parts + part) *
                      part_rows * G;

  float* qs = reinterpret_cast<float*>(smem);  // (G, D)
  float* mx = qs + G * D;                      // (G,)
  float* sm = mx + G;                          // (G,)
  S* tiles = reinterpret_cast<S*>(smem + tiles_offset(G, D));
  float* lg = reinterpret_cast<float*>(
      smem + logits_offset(G, D, a.tile_rows, sizeof(S)));  // (rows, G)

  const int d8 = D / kChunk;
  const int row_vecs = D * static_cast<int>(sizeof(S)) / 16;
  const int tile_elems = a.tile_rows * D;
  const int n_tiles = (n + a.tile_rows - 1) / a.tile_rows;
  const int* table = a.block_table + static_cast<int64_t>(b) * a.pages;
  if (mode == kScore) {  // read after the first tile's barrier
    const O* q = static_cast<const O*>(a.q) + head0 * D;
    for (int i = tid; i < G * D; i += kThreads) qs[i] = widen(q[i]);
  }

  // Copy the part's rows [first, first + rows) of pool's kv head h into
  // buf.  Thread tid copies 16-byte vectors tid, tid + kThreads, ... of
  // the tile, stepping its (row, vector) without a division; a page
  // size that is a power of two looks rows up by shifts.
  const int step_r = kThreads / row_vecs, step_c = kThreads % row_vecs;
  const int row0 = tid / row_vecs, vec0 = tid % row_vecs;
  const int ps_shift = (ps & (ps - 1)) ? -1 : __ffs(ps) - 1;
  auto stage = [&](const S* pool, int tile, S* buf) {
    const int first = lo + tile * a.tile_rows;
    const int rows = min(a.tile_rows, hi - first);
    for (int r = row0, c = vec0; r < rows;) {
      const int t = first + r;
      const int col = ps_shift >= 0 ? t >> ps_shift : t / ps;
      const int off = t - col * ps;
      const int64_t page = __ldg(table + col);
      const S* src = pool + ((page * ps + off) * a.hkv + h) * D +
                     c * Vec<S>::kN;
      cp_async16(buf + r * D + c * Vec<S>::kN, src);
      r += step_r;
      c += step_c;
      if (c >= row_vecs) {
        c -= row_vecs;
        ++r;
      }
    }
    cp_async_commit();
  };
  // Stream the part's rows of pool through the ring, kStages - 1 tiles
  // in flight ahead of the one consumed: consume(buf, base, rows) runs on
  // each tile once it has landed.  A tile past the last commits an empty
  // group, which keeps the count.
  auto stream = [&](const S* pool, auto&& consume) {
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_tiles)
        stage(pool, i, tiles + i * tile_elems);
      else
        cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int next = i + kStages - 1;
      if (next < n_tiles)
        stage(pool, next, tiles + next % kStages * tile_elems);
      else
        cp_async_commit();
      cp_async_wait_ring();
      __syncthreads();
      const int first = lo + i * a.tile_rows;
      consume(tiles + i % kStages * tile_elems, first - lo,
              min(a.tile_rows, hi - first));
      __syncthreads();
    }
  };

  if (mode == kScore) {
    int lanes = 1;  // lanes a row: the power of two covering d8
    while (lanes < d8) lanes <<= 1;
    const int rows_per_pass = kThreads / lanes;
    const int my_row = tid / lanes, my_c = tid % lanes;

    // scores: lg[r][g] = scale · q_g · k_r over the part's rows
    stream(static_cast<const S*>(a.k), [&](const S* buf, int base,
                                           int rows) {
      for (int r0 = 0; r0 < rows; r0 += rows_per_pass) {  // CTA-uniform
        const int r = r0 + my_row;
        const bool mine = my_c < d8 && r < rows;
        float x[kChunk];
        if (mine) load_chunk<S, O>(buf + r * D + my_c * kChunk, x);
        // kHeadBatch heads at a time: their dots and shuffle sums
        // interleave
        for (int g0 = 0; g0 < G; g0 += kHeadBatch) {
          float dot[kHeadBatch];
#pragma unroll
          for (int j = 0; j < kHeadBatch; ++j) {
            dot[j] = 0.f;
            if (mine && g0 + j < G) {
              const float4* qg = reinterpret_cast<const float4*>(
                  qs + (g0 + j) * D + my_c * kChunk);
              const float4 lo4 = qg[0], hi4 = qg[1];
              const float qv[kChunk] = {lo4.x, lo4.y, lo4.z, lo4.w,
                                        hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
              for (int e = 0; e < kChunk; ++e)
                dot[j] = fmaf(qv[e], x[e], dot[j]);
            }
          }
          for (int o = lanes / 2; o > 0; o >>= 1) {
#pragma unroll
            for (int j = 0; j < kHeadBatch; ++j)
              dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], o);
          }
          if (my_c == 0 && r < rows) {
#pragma unroll
            for (int j = 0; j < kHeadBatch; ++j)
              if (g0 + j < G) lg[(base + r) * G + g0 + j] = dot[j] * a.scale;
          }
        }
      }
    });

    // the part's (max, sum) of each head
    for (int g = tid / 32; g < G; g += kWarps) {
      const int lane = tid % 32;
      float m = -INFINITY;
      for (int t = lane; t < n; t += 32) m = fmaxf(m, lg[t * G + g]);
      m = warp_max(m);
      float s = 0.f;
      for (int t = lane; t < n; t += 32) s += expf(lg[t * G + g] - m);
      s = warp_sum(s);
      if (lane == 0) {
        mx[g] = m;
        sm[g] = s;
      }
    }
    __syncthreads();
    if (slot.parts > 1) {  // launch 2 finishes this part
      for (int g = tid; g < G; g += kThreads) {
        float* st = a.stats + (part * slab + head0 + g) * 2;
        st[0] = mx[g];
        st[1] = sm[g];
      }
      for (int i = tid; i < n * G; i += kThreads) lg_out[i] = lg[i];
      return;
    }
  } else {
    // every part's (max, sum) combined, in part order
    for (int g = tid; g < G; g += kThreads) {
      const float* st = a.stats + (head0 + g) * 2;
      float m = -INFINITY;
      for (int j = 0; j < slot.parts; ++j) m = fmaxf(m, st[j * slab * 2]);
      float s = 0.f;
      for (int j = 0; j < slot.parts; ++j)
        s += st[j * slab * 2 + 1] * expf(st[j * slab * 2] - m);
      mx[g] = m;
      sm[g] = s;
    }
    __syncthreads();
  }

  // probabilities, normalised and rounded to the value dtype: from the
  // logits in shared memory (launch 1) or in scratch (launch 2)
  const float* logits = mode == kScore ? lg : lg_out;
  for (int i = tid; i < n * G; i += kThreads) {
    const int g = i % G;
    lg[i] = round_to<O>(expf(logits[i] - mx[g]) / sm[g]);
  }
  __syncthreads();

  // P · V: thread pairs (head g, chunk c); with fewer pairs than threads the
  // CTA's rows go round groups of them, summed at the end
  const int pairs = G * d8;
  const int groups = pairs >= kThreads ? 1 : kThreads / pairs;
  const int my_group = pairs >= kThreads ? 0 : tid / pairs;
  const int n_mine = pairs >= kThreads
                         ? (pairs - tid + kThreads - 1) / kThreads
                         : (tid < groups * pairs ? 1 : 0);
  float acc[kPairs][kChunk];
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
#pragma unroll
    for (int e = 0; e < kChunk; ++e) acc[p][e] = 0.f;

  stream(static_cast<const S*>(a.v), [&](const S* buf, int base, int rows) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (p < n_mine) {
        const int pair = pairs >= kThreads ? tid + p * kThreads : tid % pairs;
        const int g = pair / d8, c = pair % d8;
        for (int r = my_group; r < rows; r += groups) {
          const float w = lg[(base + r) * G + g];
          float x[kChunk];
          load_chunk<S, O>(buf + r * D + c * kChunk, x);
#pragma unroll
          for (int e = 0; e < kChunk; ++e)
            acc[p][e] = fmaf(w, x[e], acc[p][e]);
        }
      }
    }
  });

  if (groups > 1) {  // sum the row groups in order; tiles are free now
    float* red = reinterpret_cast<float*>(tiles);  // (groups, pairs, kChunk)
    if (n_mine) {
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        red[(my_group * pairs + tid % pairs) * kChunk + e] = acc[0][e];
    }
    __syncthreads();
    if (tid < pairs) {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        float s = 0.f;
        for (int j = 0; j < groups; ++j)
          s += red[(j * pairs + tid) * kChunk + e];
        acc[0][e] = s;
      }
    }
  }
  const int n_out = groups > 1 ? (tid < pairs ? 1 : 0) : n_mine;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    if (p < n_out) {
      const int pair = tid + p * kThreads;
      const int64_t at = head0 * D + pair / d8 * D + pair % d8 * kChunk;
      if (mode == kScore) {
        O* out = static_cast<O*>(a.out) + at;
#pragma unroll
        for (int e = 0; e < kChunk; ++e) out[e] = narrow<O>(acc[p][e]);
      } else {
        float* dst = a.share + part * slab * D + at;
#pragma unroll
        for (int e = 0; e < kChunk; ++e) dst[e] = acc[p][e];
      }
    }
  }
}

// The output of each multi-part slot: the sum of its parts' fp32 shares,
// in part order, rounded once.
template <typename O>
__global__ void __launch_bounds__(256)
paged_attention_sum(Args a, int64_t n) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = static_cast<int>(i / (static_cast<int64_t>(a.hkv) *
                                      a.group * a.dim));
  const Slot slot = slot_of(a, b);
  if (slot.parts == 1) return;  // launch 1 wrote it
  float s = 0.f;
  for (int j = 0; j < slot.parts; ++j) s += a.share[j * n + i];
  static_cast<O*>(a.out)[i] = narrow<O>(s);
}

template <typename S, typename O>
int launch(const Args& a, int parts, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem =
      logits_offset(a.group, a.dim, a.tile_rows, sizeof(S)) +
      static_cast<size_t>(a.part_pages) * a.page_size * a.group *
          sizeof(float);
  if (smem > kMaxSmem || a.group * (a.dim / kChunk) > kMaxPairs * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = a.group * (a.dim / kChunk) <= kThreads
                    ? paged_attention_kernel<S, O, 1>
                    : paged_attention_kernel<S, O, kMaxPairs>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.hkv, a.batch, parts);
  kernel<<<grid, kThreads, smem, stream>>>(a, kScore);
  if (parts > 1) {
    kernel<<<grid, kThreads, smem, stream>>>(a, kShare);
    const int64_t n =
        static_cast<int64_t>(a.batch) * a.hkv * a.group * a.dim;
    paged_attention_sum<O>
        <<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(a, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PAGED_ATTENTION_ENTRY(NAME, S, O)                                     \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* block_table, const void* index, void* out, \
                      void* logits, void* stats, void* share, int batch,     \
                      int hkv, int group, int dim, int page_size, int pages, \
                      int part_pages, int parts, int tile_rows, float scale, \
                      void* stream) {                                        \
    Args a{q, k, v, static_cast<const int*>(block_table),                    \
           static_cast<const int*>(index), out,                             \
           static_cast<float*>(logits), static_cast<float*>(stats),         \
           static_cast<float*>(share), batch, hkv, group, dim, page_size,   \
           pages, part_pages, tile_rows, scale};                             \
    return launch<S, O>(a, parts, stream);                                   \
  }

// store dtype, value dtype
PAGED_ATTENTION_ENTRY(paged_attention_f32_f32, float, float)
PAGED_ATTENTION_ENTRY(paged_attention_f32_bf16, float, __nv_bfloat16)
PAGED_ATTENTION_ENTRY(paged_attention_f32_f16, float, __half)
PAGED_ATTENTION_ENTRY(paged_attention_bf16_f32, __nv_bfloat16, float)
PAGED_ATTENTION_ENTRY(paged_attention_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
PAGED_ATTENTION_ENTRY(paged_attention_bf16_f16, __nv_bfloat16, __half)
PAGED_ATTENTION_ENTRY(paged_attention_f16_f32, __half, float)
PAGED_ATTENTION_ENTRY(paged_attention_f16_bf16, __half, __nv_bfloat16)
PAGED_ATTENTION_ENTRY(paged_attention_f16_f16, __half, __half)
