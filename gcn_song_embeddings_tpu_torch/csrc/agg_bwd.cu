// The aggregation's backward for Hopper (sm_90a): each table row's
// gradient, gathered from the incoming gradient of the nodes that name it.
//
// Replaces no TPU kernel: the JAX package trains through XLA's autodiff of
// `conv_apply` (gcn_song_embeddings_tpu/models/pinsage.py:126), the gather
// + einsum whose forward K2 and K3 (csrc/agg.cu, csrc/dma_agg.cu) compute;
// its Pallas kernels have no backward.  With e = b T + t a flat entry of
// nb [B, T], c[e] = w[e] / den[b] (den[b] = w[b, 0] + ... + w[b, T-1]
// summed in that order from 0, rounded to the weights' 16-bit type where
// they have one, 1 where it is 0) and slope(e) = 1 where the forward's
// pre-activation q = h[nb[e]] . Wq^T + bq is >= 0, else 0.01,
//     S[n] = sum over the entries e with nb[e] = n of
//            slope(e) * c[e] * dagg[b]                      (S [N, H] f32)
// is the forward's gather-mean turned around, and then dh = S Wq,
// dWq = S^T h and dbq = sum_n S[n] (ops/agg.py; the two products are
// cuBLAS, as XLA's dots are in JAX).  No [B*T, H] tensor is formed.
//
// The slopes come from the forward's residual, never from a recomputed
// projection: K2 ("stream") keeps its projected table P [ceil(H/64)][N][64]
// (leaky_relu keeps the sign), so a table row has one slope a column; K3
// ("dma") stores q >= 0 of each entry as bits in its accumulator
// fragment's layout (csrc/dma_agg.cu): column c at bit 2 ((c % 128) / 8)
// + c % 2 of word 4 (c / 128) + (c % 8) / 2 of the entry's row of
// 4 ceil(H/128) 32-bit words, so a lane's four columns are two bits of
// two adjacent words, one 8-byte load.
//
// Order of sums: each row sums its entries in the order of `entries`
// (the CSR inverse of nb, ascending within a row), in f32, with no float
// atomics, so the gradient is the same bit for bit from run to run, and
// the plain twin (ops/agg.py `agg_bwd_rows_plain`) sums in the same
// order.  Every product, quotient and sum is an _rn intrinsic, which the
// compiler never contracts into an FMA the twin does not do: a term is
// c[e] * dagg[b], times 0.01 on the negative slope, then added.  c is
// computed once an entry first, by a thread a node (`weights_kernel`).
//
// The CSR (ops/agg.py `backward_csr`, plain twin `backward_csr_plain`, a
// stable sort) is built here too, in four kernels around one scan: the
// rows' counts (integer atomics, exact), offsets = their exclusive sum
// (the caller's), each entry dropped into its row's run by an atomic
// cursor, then each run put in ascending order, so the result is the
// stable sort's whatever order the atomics took.  A run of k <= RANK_MAX
// entries (the ids' usual runs: 1 in the frontier, a few tens in the full
// graph) is ordered by rank, a warp a row (an entry's place is the number
// of smaller entries in its run: k^2 / 32 compares a lane); a longer one,
// a hub that a power-law catalog's walks name thousands of times, is
// sorted by a block (`csr_sort_kernel`: tiles of SORT_TILE in shared
// memory, then merged in pairs, k log k / SORT_THREADS steps a thread).
//
// PASSES, the precision policy's forms (an f32 table in bf16 passes): 0
// adds each term; 1 rounds it to bf16 (nearest, ties to even) before it is
// added to its row's sum; 3 splits it into bf16 hi and lo = bf16(term -
// hi), summed into two rows, as the TPU's backward dots round their
// cotangent.  dbq sums the unrounded terms: each block writes its column
// sums of its rows to `partial` [blocks][H] (in row order), and one sum
// over the blocks finishes dbq, deterministic and without a second pass
// over S.
//
// What bounds it on the H100: bytes.  Each entry reads its node's
// gradient row (H f32, from L2 where dagg fits it) and, in K3, its H / 8
// bytes of slopes; each table row writes its S row (two in three passes).
// At the full-graph step's layer (N = B = 100k, T = 10, H 512) the
// entries' gradient rows are 2 GB read as gathered 512-byte pieces and S
// is 205 MB written: 0.67 ms at 3.35 TB/s.  At the frontier step's layer
// 0 (42,240 entries, each table row named at most once) 87 MB of rows,
// 2.7 MB of bits and 95 MB of S.
//
// Design: a warp per (table row, 128-column chunk), each lane a float4 of
// 4 columns, so a gradient row is read as 16-byte loads, 512 bytes a warp
// an entry; the entry's id and c are warp-uniform loads, and the
// unrolled loop keeps several entries' loads in flight ahead of the adds.
// A block is 8 warps over a run of 64 consecutive rows (blockIdx.y the
// chunk), each warp taking every 8th row; rows that no entry names write
// zeros.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int WARPS = 8;
constexpr int ROWS_PER_BLOCK = 64;  // ops/agg.py BWD_ROWS
constexpr int CHUNK = 128;          // columns a warp: 32 lanes x float4
constexpr int SLAB = 64;            // P columns a slab (csrc/agg.cu)
constexpr int CSR_THREADS = 256;
constexpr int RANK_MAX = 128;       // longest run a warp ranks
constexpr int SORT_THREADS = 512;   // a block a longer run
constexpr int SORT_TILE = 2048;     // entries sorted at once in shared memory
constexpr int SORT_BLOCKS = 264;    // two a multiprocessor of the H100's 132

__global__ void __launch_bounds__(CSR_THREADS)
csr_count_kernel(const int* __restrict__ ids, int n_entries,
                 int* __restrict__ counts) {
  for (int e = blockIdx.x * CSR_THREADS + threadIdx.x; e < n_entries;
       e += gridDim.x * CSR_THREADS)
    atomicAdd(counts + __ldg(ids + e), 1);
}

// counts (consumed to 0) as each row's cursor: `runs` gets each row's
// entries in the order the atomics took
__global__ void __launch_bounds__(CSR_THREADS)
csr_fill_kernel(const int* __restrict__ ids, int n_entries,
                const int* __restrict__ offsets, int* __restrict__ counts,
                int* __restrict__ runs) {
  for (int e = blockIdx.x * CSR_THREADS + threadIdx.x; e < n_entries;
       e += gridDim.x * CSR_THREADS) {
    const int n = __ldg(ids + e);
    runs[__ldg(offsets + n) + atomicSub(counts + n, 1) - 1] = e;
  }
}

// each row's run of at most RANK_MAX, a warp a row: entry x goes to place
// beg + (the run's entries below x), read as broadcast loads; a longer
// run's row is listed in long_rows [n_rows + 1] (the fill's counts, all 0
// by now: the rows at the front, their number at long_rows[n_rows]) for
// csr_sort_kernel
__global__ void __launch_bounds__(CSR_THREADS)
csr_order_kernel(const int* __restrict__ offsets,
                 const int* __restrict__ runs, int* __restrict__ entries,
                 int* __restrict__ long_rows, int n_rows) {
  const int lane = threadIdx.x % 32;
  for (int n = (blockIdx.x * CSR_THREADS + threadIdx.x) / 32; n < n_rows;
       n += gridDim.x * (CSR_THREADS / 32)) {
    const int beg = __ldg(offsets + n), k = __ldg(offsets + n + 1) - beg;
    if (k > RANK_MAX) {
      if (lane == 0) long_rows[atomicAdd(long_rows + n_rows, 1)] = n;
      continue;
    }
    for (int i = lane; i < k; i += 32) {
      const int x = __ldg(runs + beg + i);
      int r = 0;
      for (int j = 0; j < k; ++j) r += __ldg(runs + beg + j) < x;
      entries[beg + r] = x;
    }
  }
}

// outputs [o, end) of the merge of src's sorted stretches of w in pairs
// (of a run of k) into dst: for each pair the stretch begins in, its
// split between the two found by binary search on the diagonal (merge
// path), then merged in order.  Plain loads: the block wrote src.
__device__ void merge_stretch(const int* src, int* dst, long long k,
                              long long w, long long o, long long end) {
  while (o < end) {
    const long long base = o / (2 * w) * (2 * w);
    const int a_len = (int)min(w, k - base);
    const int b_len = (int)min(w, k - base - a_len);
    const int* a = src + base;
    const int* b = a + a_len;
    const long long stop = min(end, base + a_len + b_len);
    const int diag = (int)(o - base);
    int lo = max(0, diag - b_len), hi = min(diag, a_len);
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (a[mid] < b[diag - 1 - mid])
        lo = mid + 1;
      else
        hi = mid;
    }
    int i = lo, j = diag - lo;
    for (; o < stop; ++o) {
      const bool take_a = j >= b_len || (i < a_len && a[i] < b[j]);
      dst[o] = take_a ? a[i++] : b[j++];
    }
  }
}

// each listed long run sorted into entries, a block a run: its tiles of
// SORT_TILE sorted in shared memory (a bitonic network of the least power
// of 2 that holds the run, at most SORT_TILE), then merged in pairs of
// doubling width, each thread a stretch of the output, back and forth
// between runs and entries (the tiles land where the last merge ends in
// entries)
__global__ void __launch_bounds__(SORT_THREADS)
csr_sort_kernel(const int* __restrict__ offsets, int* runs, int* entries,
                const int* __restrict__ long_rows, int n_rows) {
  __shared__ int tile[SORT_TILE];
  const int n_long = long_rows[n_rows];
  for (int r = blockIdx.x; r < n_long; r += gridDim.x) {
    const int n = long_rows[r];
    const int beg = offsets[n], k = offsets[n + 1] - beg;
    const int tiles = (k + SORT_TILE - 1) / SORT_TILE;
    int merges = 0;
    while ((1 << merges) < tiles) ++merges;
    int* src = merges % 2 ? runs + beg : entries + beg;
    int* dst = merges % 2 ? entries + beg : runs + beg;
    int width = 2;
    while (width < k && width < SORT_TILE) width <<= 1;
    for (int t0 = 0; t0 < k; t0 += SORT_TILE) {
      for (int j = threadIdx.x; j < width; j += SORT_THREADS)
        tile[j] = t0 + j < k ? runs[beg + t0 + j] : INT_MAX;
      __syncthreads();
      for (int size = 2; size <= width; size <<= 1)
        for (int stride = size / 2; stride > 0; stride /= 2) {
          for (int j = threadIdx.x; j < width / 2; j += SORT_THREADS) {
            const int lo = 2 * stride * (j / stride) + j % stride;
            const int x = tile[lo], y = tile[lo + stride];
            if ((x > y) == ((lo & size) == 0)) {
              tile[lo] = y;
              tile[lo + stride] = x;
            }
          }
          __syncthreads();
        }
      for (int j = threadIdx.x; j < width && t0 + j < k; j += SORT_THREADS)
        src[t0 + j] = tile[j];
      __syncthreads();
    }
    const long long per = (k + SORT_THREADS - 1) / SORT_THREADS;
    for (long long w = SORT_TILE; w < k; w *= 2) {
      merge_stretch(src, dst, k, w, min((long long)k, threadIdx.x * per),
                    min((long long)k, (threadIdx.x + 1) * per));
      __syncthreads();
      int* t = src;
      src = dst;
      dst = t;
    }
  }
}

// c [B*T] = w / den, a thread a node: den its T weights summed in order
// from 0, rounded to bf16 (den_round 1) or f16 (2) as the forward takes
// a 16-bit weights' sum, 1 where it is 0
__global__ void __launch_bounds__(CSR_THREADS)
weights_kernel(const float* __restrict__ w, int n_nodes, int T,
               int den_round, float* __restrict__ c) {
  for (int b = blockIdx.x * CSR_THREADS + threadIdx.x; b < n_nodes;
       b += gridDim.x * CSR_THREADS) {
    const float* wb = w + (size_t)b * T;
    float s = 0.f;
    for (int t = 0; t < T; ++t) s = __fadd_rn(s, __ldg(wb + t));
    if (den_round == 1) s = __bfloat162float(__float2bfloat16_rn(s));
    if (den_round == 2) s = __half2float(__float2half_rn(s));
    if (s == 0.f) s = 1.f;
    for (int t = 0; t < T; ++t)
      c[(size_t)b * T + t] = __fdiv_rn(__ldg(wb + t), s);
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one column's term into the row's sums: hi (the sum, or the sum of bf16
// parts), lo (three passes: the sum of the lo parts), full (the
// unrounded sum, for dbq, under the passes)
template <int PASSES>
__device__ __forceinline__ void add_term(float t, float& hi, float& lo,
                                         float& full) {
  if constexpr (PASSES == 0) {
    hi = __fadd_rn(hi, t);
  } else {
    const float h = bf16_round(t);
    hi = __fadd_rn(hi, h);
    if constexpr (PASSES == 3) lo = __fadd_rn(lo, bf16_round(__fsub_rn(t, h)));
    full = __fadd_rn(full, t);
  }
}

__device__ __forceinline__ float slope_term(float c, float d, uint32_t bit) {
  const float t = __fmul_rn(c, d);
  return bit ? t : __fmul_rn(0.01f, t);
}

template <int PASSES, bool ROW_SLOPES>
__global__ void __launch_bounds__(WARPS * 32)
agg_bwd_kernel(const int* __restrict__ offsets,    // [N + 1]
               const int* __restrict__ entries,    // [B*T]
               const float* __restrict__ c,        // [B*T]
               const float* __restrict__ dagg,     // [B, H]
               const float* __restrict__ proj,     // K2: [S][N][64]
               const uint32_t* __restrict__ bits,  // K3: [B*T][words]
               float* __restrict__ s_hi,           // [N, H]
               float* __restrict__ s_lo,           // [N, H], PASSES 3
               float* __restrict__ partial,        // [blocks, H]
               int n_rows, int T, int hdim) {
  __shared__ float4 red[WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.y * CHUNK + 4 * lane;
  const bool live = col < hdim;  // H % 4 == 0: all four columns or none
  const int words = 4 * ((hdim + CHUNK - 1) / CHUNK);
  // K3's bits of the lane's columns: bits 2 i, 2 i + 1 of two words
  const int word = 4 * (col / CHUNK) + (col % 8) / 2;
  const int shift = 2 * ((col % CHUNK) / 8);
  const int first = blockIdx.x * ROWS_PER_BLOCK;
  float4 colsum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = warp; r < ROWS_PER_BLOCK && live; r += WARPS) {
    const int n = first + r;
    if (n >= n_rows) break;
    const int beg = __ldg(offsets + n), end = __ldg(offsets + n + 1);
    float4 hi = make_float4(0.f, 0.f, 0.f, 0.f), lo = hi, full = hi;
    uint32_t row_bits = 0;
    if (ROW_SLOPES && beg < end) {
      const float4 p = __ldg(reinterpret_cast<const float4*>(
          proj + ((size_t)(col / SLAB) * n_rows + n) * SLAB + col % SLAB));
      row_bits = (p.x >= 0.f ? 1u : 0u) | (p.y >= 0.f ? 2u : 0u) |
                 (p.z >= 0.f ? 4u : 0u) | (p.w >= 0.f ? 8u : 0u);
    }
#pragma unroll 4
    for (int k = beg; k < end; ++k) {
      const int e = __ldg(entries + k);
      const float ce = __ldg(c + e);
      const float4 d = __ldg(reinterpret_cast<const float4*>(
          dagg + (size_t)(e / T) * hdim + col));
      uint32_t s = row_bits;
      if (!ROW_SLOPES) {
        const uint2 ab = __ldg(
            reinterpret_cast<const uint2*>(bits + (size_t)e * words + word));
        s = ((ab.x >> shift) & 3u) | (((ab.y >> shift) & 3u) << 2);
      }
      add_term<PASSES>(slope_term(ce, d.x, s & 1u), hi.x, lo.x, full.x);
      add_term<PASSES>(slope_term(ce, d.y, s & 2u), hi.y, lo.y, full.y);
      add_term<PASSES>(slope_term(ce, d.z, s & 4u), hi.z, lo.z, full.z);
      add_term<PASSES>(slope_term(ce, d.w, s & 8u), hi.w, lo.w, full.w);
    }
    *reinterpret_cast<float4*>(s_hi + (size_t)n * hdim + col) = hi;
    if constexpr (PASSES == 3)
      *reinterpret_cast<float4*>(s_lo + (size_t)n * hdim + col) = lo;
    const float4 u = PASSES == 0 ? hi : full;
    colsum.x += u.x;
    colsum.y += u.y;
    colsum.z += u.z;
    colsum.w += u.w;
  }
  red[warp][lane] = colsum;
  __syncthreads();
  if (warp == 0 && live) {
    float4 s = red[0][lane];
#pragma unroll
    for (int v = 1; v < WARPS; ++v) {
      s.x += red[v][lane].x;
      s.y += red[v][lane].y;
      s.z += red[v][lane].z;
      s.w += red[v][lane].w;
    }
    *reinterpret_cast<float4*>(partial + (size_t)blockIdx.x * hdim + col) = s;
  }
}

template <int PASSES>
cudaError_t launch_passes(const int* offsets, const int* entries,
                          const float* c, const float* dagg,
                          const float* proj, const uint32_t* bits,
                          float* s_hi, float* s_lo, float* partial,
                          int n_rows, int T, int hdim, cudaStream_t stream) {
  const dim3 grid((n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                  (hdim + CHUNK - 1) / CHUNK);
  if (proj != nullptr)
    agg_bwd_kernel<PASSES, true><<<grid, WARPS * 32, 0, stream>>>(
        offsets, entries, c, dagg, proj, bits, s_hi, s_lo, partial, n_rows,
        T, hdim);
  else
    agg_bwd_kernel<PASSES, false><<<grid, WARPS * 32, 0, stream>>>(
        offsets, entries, c, dagg, proj, bits, s_hi, s_lo, partial, n_rows,
        T, hdim);
  return cudaGetLastError();
}

}  // namespace

static unsigned csr_blocks(long long n) {
  return (unsigned)std::min<long long>((n + CSR_THREADS - 1) / CSR_THREADS,
                                       65535);
}

// The CSR's first half: counts [N + 1] (N of the ids [E], in [0, N), and
// one more for the second half), zeroed here
extern "C" int agg_bwd_csr_count_launch(const void* ids, int n_entries,
                                        int n_rows, void* counts,
                                        void* stream) {
  if (n_entries < 0 || n_rows < 1) return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, ((size_t)n_rows + 1) * 4, st);
  if (err != cudaSuccess || n_entries == 0) return (int)err;
  csr_count_kernel<<<csr_blocks(n_entries), CSR_THREADS, 0, st>>>(
      (const int*)ids, n_entries, (int*)counts);
  return (int)cudaGetLastError();
}

// Its second half, after offsets [N + 1] = the counts' exclusive sum:
// entries [E], each row's run ascending (`runs` [E] scratch; counts
// consumed, then the list of long runs)
extern "C" int agg_bwd_csr_fill_launch(const void* ids, int n_entries,
                                       int n_rows, const void* offsets,
                                       void* counts, void* runs,
                                       void* entries, void* stream) {
  if (n_entries < 0 || n_rows < 1) return (int)cudaErrorInvalidValue;
  if (n_entries == 0) return (int)cudaSuccess;
  const auto st = (cudaStream_t)stream;
  csr_fill_kernel<<<csr_blocks(n_entries), CSR_THREADS, 0, st>>>(
      (const int*)ids, n_entries, (const int*)offsets, (int*)counts,
      (int*)runs);
  csr_order_kernel<<<csr_blocks((long long)n_rows * 32), CSR_THREADS, 0,
                     st>>>((const int*)offsets, (const int*)runs,
                           (int*)entries, (int*)counts, n_rows);
  if (n_entries > RANK_MAX)  // else no run is long: E / (RANK_MAX + 1) at most
    csr_sort_kernel<<<std::min(SORT_BLOCKS, n_entries / (RANK_MAX + 1)),
                      SORT_THREADS, 0, st>>>((const int*)offsets, (int*)runs,
                                             (int*)entries,
                                             (const int*)counts, n_rows);
  return (int)cudaGetLastError();
}

// S (and its lo part in three passes) and the dbq partials of a checked
// problem: w the weights [B, T] f32 (den_round 1 / 2: their denominator
// rounded to bf16 / f16, the forward's for 16-bit weights), c [B*T] f32
// scratch for w / den; exactly one of `proj` (K2's residual) and `bits`
// (K3's, 8-byte aligned) is given; passes 0 (as it is), 1 or 3 (bf16
// parts).
extern "C" int agg_bwd_launch(const void* offsets, const void* entries,
                              const void* w, void* c, const void* dagg,
                              const void* proj, const void* bits,
                              void* s_hi, void* s_lo, void* partial,
                              int n_nodes, int n_rows, int T, int hdim,
                              int passes, int den_round, void* stream) {
  if (n_nodes < 1 || n_rows < 1 || T < 1 || hdim < 1 || hdim % 4 != 0 ||
      den_round < 0 || den_round > 2 || (uintptr_t)bits % 8 != 0 ||
      (passes != 0 && passes != 1 && passes != 3) ||
      (passes == 3) != (s_lo != nullptr) ||
      (proj == nullptr) == (bits == nullptr) ||
      (uintptr_t)dagg % 16 != 0 || (uintptr_t)proj % 16 != 0 ||
      (uintptr_t)s_hi % 16 != 0 || (uintptr_t)s_lo % 16 != 0 ||
      (uintptr_t)partial % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* o = (const int*)offsets;
  const auto* en = (const int*)entries;
  auto* cc = (float*)c;
  const auto* d = (const float*)dagg;
  const auto* p = (const float*)proj;
  const auto* b = (const uint32_t*)bits;
  auto* hi = (float*)s_hi;
  auto* lo = (float*)s_lo;
  auto* part = (float*)partial;
  const auto st = (cudaStream_t)stream;
  weights_kernel<<<csr_blocks(n_nodes), CSR_THREADS, 0, st>>>(
      (const float*)w, n_nodes, T, den_round, cc);
  const cudaError_t err =
      passes == 0   ? launch_passes<0>(o, en, cc, d, p, b, hi, lo, part,
                                       n_rows, T, hdim, st)
      : passes == 1 ? launch_passes<1>(o, en, cc, d, p, b, hi, lo, part,
                                       n_rows, T, hdim, st)
                    : launch_passes<3>(o, en, cc, d, p, b, hi, lo, part,
                                       n_rows, T, hdim, st);
  return (int)err;
}

extern "C" const char* agg_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
