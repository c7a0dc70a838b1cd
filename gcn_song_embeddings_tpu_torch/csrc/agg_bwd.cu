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
// order.  A run of at most RANK_MAX (128) entries is summed from 0 in
// that order; a longer one (a hub) is cut at multiples of 128 from its
// start, each chunk summed from 0 in order by a warp of its own, and the
// chunks' sums added from 0 in chunk order.  Every product, quotient and
// sum is an _rn intrinsic, which the compiler never contracts into an FMA
// the twin does not do: a term is c[e] * dagg[b], times 0.01 on the
// negative slope, then added.  c is computed once an entry first, by a
// thread a node (`weights_kernel`).
//
// The frontier form (`agg_bwd_frontier_kernel`, twin
// `agg_bwd_frontier_plain`): where the caller states that entry e is
// table row e (the frontier forward's ids are an arange, each row named
// once), S[e] is the one term added to 0, the table form's sum bit for
// bit, and no CSR is built: one kernel, a warp a node, which sums the
// node's weights, reads its gradient once and writes its T rows of S.
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
// entries' gradient rows are 2 GB read as gathered 2 KB rows (dagg, 205
// MB, does not fit the 50 MB L2) and S is 205 MB written.  At the
// frontier step's layer 0 (42,240 entries, each row named once) the
// frontier form reads dagg once (8.6 MB) and 2.7 MB of bits and writes
// 86.5 MB of S.
//
// Design of the table form: a warp a table row at a time over one
// 128-column chunk of it (blockIdx.y the chunk), each lane a float4 of
// four columns, walking the row's entries in order, four unrolled.  A
// block is 8 warps over a run of 64 consecutive rows, each warp taking
// every 8th row; rows that no entry names write zeros.  The long runs'
// chunks are summed first by `agg_bwd_hub_kernel`, a warp a chunk
// anywhere on the card, into slots the row's warp then adds in chunk
// order, so a hub costs about what a row of uniform ids does.  S is
// stored and K2's projected rows read evict-first (each touched once).

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
constexpr int RANK_MAX = 128;       // longest run a warp ranks and sums
constexpr int SORT_THREADS = 512;   // a block a longer run
constexpr int SORT_TILE = 2048;     // entries sorted at once in shared memory
constexpr int SORT_BLOCKS = 264;    // two a multiprocessor of the H100's 132
// the hub kernel's blocks a column chunk, two a multiprocessor: its warps
// take the long runs' chunks grid-stride, and where no run is long (the
// usual case) each block only reads the count and exits
constexpr int HUB_BLOCKS = 264;

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
// a 16-bit weights' sum, 1 where it is 0; with offsets given, a thread a
// table row too: each row whose run is longer than RANK_MAX listed in
// long_rows [N + 1] (their number at long_rows[N], zeroed before), in the
// order the atomics take
__global__ void __launch_bounds__(CSR_THREADS)
weights_kernel(const float* __restrict__ w, int n_nodes, int T,
               int den_round, float* __restrict__ c,
               const int* __restrict__ offsets, int n_rows,
               int* __restrict__ long_rows) {
  for (int b = blockIdx.x * CSR_THREADS + threadIdx.x;
       b < n_nodes || (offsets != nullptr && b < n_rows);
       b += gridDim.x * CSR_THREADS) {
    if (offsets != nullptr && b < n_rows &&
        __ldg(offsets + b + 1) - __ldg(offsets + b) > RANK_MAX)
      long_rows[atomicAdd(long_rows + n_rows, 1)] = b;
    if (b >= n_nodes) continue;
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

// a lane's four adjacent columns
struct Frag {
  float v[4];
};

__device__ __forceinline__ void zero(Frag& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f.v[i] = 0.f;
}

__device__ __forceinline__ void add(Frag& a, const Frag& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.v[i] = __fadd_rn(a.v[i], b.v[i]);
}

// loads and stores of a fragment: cached (ld), read once (ldcs: evict
// first), written once (stcs) or as scratch (st)
template <bool ONCE = false>
__device__ __forceinline__ Frag load(const float* p) {
  const float4 x = ONCE ? __ldcs(reinterpret_cast<const float4*>(p))
                        : __ldg(reinterpret_cast<const float4*>(p));
  return Frag{{x.x, x.y, x.z, x.w}};
}

template <bool ONCE = false>
__device__ __forceinline__ void store(float* p, const Frag& f) {
  const float4 x = make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
  if constexpr (ONCE)
    __stcs(reinterpret_cast<float4*>(p), x);
  else
    *reinterpret_cast<float4*>(p) = x;
}

// the slope bits (1 << i of column col + i) of a lane's four columns col
// .. col + 3 (col % 4 == 0): K2's projected row n (read once), or K3's
// bits of entry e (two bits of each of two adjacent words)
__device__ __forceinline__ uint32_t row_slope_bits(const float* proj,
                                                   int n_rows, int n,
                                                   int col) {
  const Frag p = load<true>(
      proj + ((size_t)(col / SLAB) * n_rows + n) * SLAB + col % SLAB);
  return (p.v[0] >= 0.f ? 1u : 0u) | (p.v[1] >= 0.f ? 2u : 0u) |
         (p.v[2] >= 0.f ? 4u : 0u) | (p.v[3] >= 0.f ? 8u : 0u);
}

__device__ __forceinline__ uint32_t entry_slope_bits(const uint32_t* bits,
                                                     size_t e, int words,
                                                     int col) {
  const uint2 ab = __ldg(reinterpret_cast<const uint2*>(
      bits + e * words + 4 * (col / CHUNK) + (col % 8) / 2));
  const int shift = 2 * ((col % CHUNK) / 8);
  return ((ab.x >> shift) & 3u) | (((ab.y >> shift) & 3u) << 2);
}

// a term c * d of each of the lane's columns (slope bits s) into the sums
template <int PASSES>
__device__ __forceinline__ void add_terms(float ce, const Frag& d,
                                          uint32_t s, Frag& hi,
                                          Frag& lo, Frag& full) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    add_term<PASSES>(slope_term(ce, d.v[i], s & (1u << i)), hi.v[i],
                     lo.v[i], full.v[i]);
}

// Entries [beg, end) of `entries` summed in that order onto hi / lo / full
// (the lane's four columns from col): each entry's id, then its c, its
// node's gradient fragment and (K3) its slope bits, four entries unrolled
template <int PASSES, bool ROW_SLOPES>
__device__ __forceinline__ void sum_run(
    int beg, int end, const int* __restrict__ entries,
    const float* __restrict__ c, const float* __restrict__ dagg,
    const uint32_t* __restrict__ bits, int T, int hdim, int words, int col,
    uint32_t row_bits, Frag& hi, Frag& lo, Frag& full) {
#pragma unroll 4
  for (int k = beg; k < end; ++k) {
    const int e = __ldg(entries + k);
    const uint32_t s =
        ROW_SLOPES ? row_bits : entry_slope_bits(bits, e, words, col);
    add_terms<PASSES>(__ldg(c + e), load(dagg + (size_t)(e / T) * hdim + col),
                      s, hi, lo, full);
  }
}

// The table form's long runs, first: each run of more than RANK_MAX
// entries (listed by weights_kernel) cut at multiples of RANK_MAX from its
// start, each chunk summed from 0 in entry order by a warp of its own.
// The listed runs' chunks are numbered in list order and the grid's warps
// take them in turn (warp v the chunks v, v + V, ...: each warp reads the
// list 32 runs at a time and finds its chunks by a scan of their chunk
// counts), so a hub is spread over the whole card.  A full chunk's sums
// go to slot (its first CSR place) / RANK_MAX of chunk_* [2 n_slots][H],
// a run's last, shorter chunk's to slot n_slots + (the run's last place)
// / RANK_MAX: full chunks are RANK_MAX places apart and so are two long
// runs' ends, so no two chunks share a slot, and the sums do not depend
// on the list's order.  blockIdx.y is the 128-column chunk.
template <int PASSES, bool ROW_SLOPES>
__global__ void __launch_bounds__(WARPS * 32)
agg_bwd_hub_kernel(const int* __restrict__ offsets,
                   const int* __restrict__ entries,
                   const float* __restrict__ c,
                   const float* __restrict__ dagg,
                   const float* __restrict__ proj,
                   const uint32_t* __restrict__ bits,
                   const int* __restrict__ long_rows,
                   float* __restrict__ chunk_hi, float* __restrict__ chunk_lo,
                   float* __restrict__ chunk_full, int n_rows, int n_slots,
                   int T, int hdim) {
  const int n_long = long_rows[n_rows];
  if (n_long == 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.y * CHUNK + 4 * lane;
  const int words = 4 * ((hdim + CHUNK - 1) / CHUNK);
  const long long v = (long long)blockIdx.x * WARPS + warp;
  const long long n_warps = (long long)gridDim.x * WARPS;
  long long base = 0;  // chunks of the listed runs before this batch
  for (int r0 = 0; r0 < n_long; r0 += 32) {
    int n = 0, beg = 0, end = 0, chunks = 0;
    if (r0 + lane < n_long) {
      n = long_rows[r0 + lane];
      beg = __ldg(offsets + n);
      end = __ldg(offsets + n + 1);
      chunks = (end - beg + RANK_MAX - 1) / RANK_MAX;
    }
    int upto = chunks;  // inclusive scan of the lanes' chunk counts
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, upto, d);
      if (lane >= d) upto += y;
    }
    const int total = __shfl_sync(0xffffffffu, upto, 31);
    for (long long g = base + ((v - base) % n_warps + n_warps) % n_warps;
         g < base + total; g += n_warps) {
      const int local = (int)(g - base);
      const unsigned hit = __ballot_sync(
          0xffffffffu, local >= upto - chunks && local < upto);
      const int src = __ffs(hit) - 1;
      const int row = __shfl_sync(0xffffffffu, n, src);
      const int rbeg = __shfl_sync(0xffffffffu, beg, src);
      const int rend = __shfl_sync(0xffffffffu, end, src);
      const int j = local - __shfl_sync(0xffffffffu, upto - chunks, src);
      const int first = rbeg + j * RANK_MAX;
      const int last = min(first + RANK_MAX, rend);
      if (col < hdim) {
        const uint32_t row_bits =
            ROW_SLOPES ? row_slope_bits(proj, n_rows, row, col) : 0u;
        Frag hi, lo, full;
        zero(hi);
        zero(lo);
        zero(full);
        sum_run<PASSES, ROW_SLOPES>(first, last, entries, c, dagg, bits, T,
                                    hdim, words, col, row_bits, hi, lo,
                                    full);
        const size_t slot = last - first == RANK_MAX
                                ? (size_t)(first / RANK_MAX)
                                : (size_t)n_slots + (rend - 1) / RANK_MAX;
        const size_t at = slot * hdim + col;
        store(chunk_hi + at, hi);
        if constexpr (PASSES == 3) store(chunk_lo + at, lo);
        if constexpr (PASSES != 0) store(chunk_full + at, full);
      }
    }
    base += total;
  }
}

// A row finished: its sums (hi, lo; full for dbq) stored as row n of S
// (evict-first) and added to the lane's column sums.  A long run's row
// (k > RANK_MAX entries from place beg) first takes the sum from 0, in
// chunk order, of its chunks' sums (agg_bwd_hub_kernel's slots).
template <int PASSES>
__device__ __forceinline__ void finish_row(
    int n, bool long_run, int beg, int end, int col, int hdim, int n_slots,
    const float* __restrict__ chunk_hi, const float* __restrict__ chunk_lo,
    const float* __restrict__ chunk_full, float* __restrict__ s_hi,
    float* __restrict__ s_lo, Frag& hi, Frag& lo, Frag& full,
    Frag& colsum) {
  if (long_run) {
    const int k = end - beg, chunks = (k + RANK_MAX - 1) / RANK_MAX;
#pragma unroll 8
    for (int j = 0; j < chunks; ++j) {
      const size_t slot = j < k / RANK_MAX
                              ? (size_t)((beg + j * RANK_MAX) / RANK_MAX)
                              : (size_t)n_slots + (end - 1) / RANK_MAX;
      const size_t at = slot * hdim + col;
      add(hi, load(chunk_hi + at));
      if constexpr (PASSES == 3) add(lo, load(chunk_lo + at));
      if constexpr (PASSES != 0) add(full, load(chunk_full + at));
    }
  }
  store<true>(s_hi + (size_t)n * hdim + col, hi);
  if constexpr (PASSES == 3) store<true>(s_lo + (size_t)n * hdim + col, lo);
  const Frag& u = PASSES == 0 ? hi : full;
#pragma unroll
  for (int i = 0; i < 4; ++i) colsum.v[i] += u.v[i];
}

// The table form: a warp a table row at a time over a 128-column chunk
// of it (blockIdx.y the chunk), each warp of the block taking every 8th
// of its 64 rows.  A run of at most RANK_MAX entries is summed from 0 in
// entry order (sum_run); a longer run's row takes its chunks' sums.  Rows
// that no entry names write zeros.
template <int PASSES, bool ROW_SLOPES>
__global__ void __launch_bounds__(WARPS * 32)
agg_bwd_kernel(const int* __restrict__ offsets,    // [N + 1]
               const int* __restrict__ entries,    // [B*T]
               const float* __restrict__ c,        // [B*T]
               const float* __restrict__ dagg,     // [B, H]
               const float* __restrict__ proj,     // K2: [S][N][64]
               const uint32_t* __restrict__ bits,  // K3: [B*T][words]
               const float* __restrict__ chunk_hi,    // [2 n_slots, H]
               const float* __restrict__ chunk_lo,    // PASSES 3
               const float* __restrict__ chunk_full,  // PASSES 1, 3
               float* __restrict__ s_hi,           // [N, H]
               float* __restrict__ s_lo,           // [N, H], PASSES 3
               float* __restrict__ partial,        // [blocks, H]
               int n_rows, int n_slots, int T, int hdim) {
  __shared__ Frag red[WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.y * CHUNK + 4 * lane;
  const bool live = col < hdim;  // H % 4 == 0: all four columns or none
  const int words = 4 * ((hdim + CHUNK - 1) / CHUNK);
  const int first = blockIdx.x * ROWS_PER_BLOCK;
  Frag colsum;
  zero(colsum);
  for (int r = warp; r < ROWS_PER_BLOCK && live; r += WARPS) {
    const int n = first + r;
    if (n >= n_rows) break;
    const int beg = __ldg(offsets + n), end = __ldg(offsets + n + 1);
    Frag hi, lo, full;
    zero(hi);
    zero(lo);
    zero(full);
    if (end - beg <= RANK_MAX) {
      const uint32_t row_bits =
          ROW_SLOPES && end > beg ? row_slope_bits(proj, n_rows, n, col) : 0u;
      sum_run<PASSES, ROW_SLOPES>(beg, end, entries, c, dagg, bits, T, hdim,
                                  words, col, row_bits, hi, lo, full);
    }
    finish_row<PASSES>(n, end - beg > RANK_MAX, beg, end, col, hdim, n_slots,
                       chunk_hi, chunk_lo, chunk_full, s_hi, s_lo, hi, lo,
                       full, colsum);
  }
  red[warp][lane] = colsum;
  __syncthreads();
  if (warp == 0 && live) {
    Frag s = red[0][lane];
#pragma unroll
    for (int v = 1; v < WARPS; ++v)
#pragma unroll
      for (int i = 0; i < 4; ++i) s.v[i] += red[v][lane].v[i];
    store(partial + (size_t)blockIdx.x * hdim + col, s);
  }
}

// The frontier form, where entry e = b T + t is table row e (each row
// named once, so no CSR): a warp a node at a time (nodes_per_block to a
// block, blockIdx.y the 128-column chunk).  It sums the node's T weights
// in order from 0 (rounded as weights_kernel rounds them), reads its
// gradient's four columns once, and writes row b T + t of S for each t:
// the one term added to 0, bit for bit the table form's sum of a row
// named once.  S streams out (evict-first): cuBLAS reads it once, after.
template <int PASSES, bool ROW_SLOPES>
__global__ void __launch_bounds__(WARPS * 32)
agg_bwd_frontier_kernel(const float* __restrict__ w,        // [B, T]
                        const float* __restrict__ dagg,     // [B, H]
                        const float* __restrict__ proj,     // K2: [S][BT][64]
                        const uint32_t* __restrict__ bits,  // K3: [BT][words]
                        float* __restrict__ s_hi,           // [B*T, H]
                        float* __restrict__ s_lo,           // PASSES 3
                        float* __restrict__ partial,        // [blocks, H]
                        int n_nodes, int T, int hdim, int den_round,
                        int nodes_per_block) {
  __shared__ Frag red[WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.y * CHUNK + 4 * lane;
  const bool live = col < hdim;  // H % 4 == 0: all four columns or none
  const int words = 4 * ((hdim + CHUNK - 1) / CHUNK);
  const int n_rows = n_nodes * T;
  Frag colsum;
  zero(colsum);
  for (int i = warp; i < nodes_per_block && live; i += WARPS) {
    const int b = blockIdx.x * nodes_per_block + i;
    if (b >= n_nodes) break;
    const float* wb = w + (size_t)b * T;
    float den = 0.f;
    for (int t = 0; t < T; ++t) den = __fadd_rn(den, __ldg(wb + t));
    if (den_round == 1) den = bf16_round(den);
    if (den_round == 2) den = __half2float(__float2half_rn(den));
    if (den == 0.f) den = 1.f;
    const Frag d = load(dagg + (size_t)b * hdim + col);
#pragma unroll 4
    for (int t = 0; t < T; ++t) {
      const int e = b * T + t;
      const float ce = __fdiv_rn(__ldg(wb + t), den);
      const uint32_t s = ROW_SLOPES
                             ? row_slope_bits(proj, n_rows, e, col)
                             : entry_slope_bits(bits, e, words, col);
      Frag hi, lo, full;
      zero(hi);
      zero(lo);
      zero(full);
      add_terms<PASSES>(ce, d, s, hi, lo, full);
      store<true>(s_hi + (size_t)e * hdim + col, hi);
      if constexpr (PASSES == 3)
        store<true>(s_lo + (size_t)e * hdim + col, lo);
      const Frag& u = PASSES == 0 ? hi : full;
#pragma unroll
      for (int j = 0; j < 4; ++j) colsum.v[j] += u.v[j];
    }
  }
  red[warp][lane] = colsum;
  __syncthreads();
  if (warp == 0 && live) {
    Frag s = red[0][lane];
#pragma unroll
    for (int v = 1; v < WARPS; ++v)
#pragma unroll
      for (int j = 0; j < 4; ++j) s.v[j] += red[v][lane].v[j];
    store(partial + (size_t)blockIdx.x * hdim + col, s);
  }
}

struct TableArgs {
  const int* offsets;
  const int* entries;
  const float* c;
  const float* dagg;
  const float* proj;
  const uint32_t* bits;
  const int* long_rows;
  float* chunk_hi;
  float* chunk_lo;
  float* chunk_full;
  float* s_hi;
  float* s_lo;
  float* partial;
  int n_rows, n_slots, T, hdim;
};

template <int PASSES, bool ROW_SLOPES>
cudaError_t launch_table(const TableArgs& a, cudaStream_t stream) {
  const int chunks = (a.hdim + CHUNK - 1) / CHUNK;
  if (a.n_slots > 1) {  // else E <= RANK_MAX: no run is longer
    const dim3 hub(std::min((a.n_slots + WARPS - 1) / WARPS, HUB_BLOCKS),
                   chunks);
    agg_bwd_hub_kernel<PASSES, ROW_SLOPES><<<hub, WARPS * 32, 0,
                                                  stream>>>(
        a.offsets, a.entries, a.c, a.dagg, a.proj, a.bits, a.long_rows,
        a.chunk_hi, a.chunk_lo, a.chunk_full, a.n_rows, a.n_slots, a.T,
        a.hdim);
  }
  const dim3 grid((a.n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, chunks);
  agg_bwd_kernel<PASSES, ROW_SLOPES><<<grid, WARPS * 32, 0, stream>>>(
      a.offsets, a.entries, a.c, a.dagg, a.proj, a.bits, a.chunk_hi,
      a.chunk_lo, a.chunk_full, a.s_hi, a.s_lo, a.partial, a.n_rows,
      a.n_slots, a.T, a.hdim);
  return cudaGetLastError();
}

template <int PASSES>
cudaError_t launch_passes(const TableArgs& a, cudaStream_t stream) {
  return a.proj != nullptr ? launch_table<PASSES, true>(a, stream)
                           : launch_table<PASSES, false>(a, stream);
}

template <int PASSES>
cudaError_t launch_frontier(const float* w, const float* dagg,
                            const float* proj, const uint32_t* bits,
                            float* s_hi, float* s_lo, float* partial,
                            int n_nodes, int T, int hdim, int den_round,
                            int nodes_per_block, cudaStream_t stream) {
  const dim3 grid((n_nodes + nodes_per_block - 1) / nodes_per_block,
                  (hdim + CHUNK - 1) / CHUNK);
  if (proj != nullptr)
    agg_bwd_frontier_kernel<PASSES, true><<<grid, WARPS * 32, 0, stream>>>(
        w, dagg, proj, bits, s_hi, s_lo, partial, n_nodes, T, hdim,
        den_round, nodes_per_block);
  else
    agg_bwd_frontier_kernel<PASSES, false><<<grid, WARPS * 32, 0, stream>>>(
        w, dagg, proj, bits, s_hi, s_lo, partial, n_nodes, T, hdim,
        den_round, nodes_per_block);
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

// The table form: S (and its lo part in three passes) and the dbq
// partials of a checked problem: w the weights [B, T] f32 (den_round 1 /
// 2: their denominator rounded to bf16 / f16, the forward's for 16-bit
// weights), c [B*T] f32 scratch for w / den; exactly one of `proj` (K2's
// residual) and `bits` (K3's, 8-byte aligned) is given; passes 0 (as it
// is), 1 or 3 (bf16 parts); long_rows [N + 1] int32 scratch for the list
// of long runs; chunk_hi (and chunk_lo with three passes, chunk_full with
// one or three) [2 n_slots][H] scratch for their chunks' sums, n_slots =
// ceil(E / 128).
extern "C" int agg_bwd_launch(const void* offsets, const void* entries,
                              const void* w, void* c, const void* dagg,
                              const void* proj, const void* bits,
                              void* long_rows, void* chunk_hi,
                              void* chunk_lo, void* chunk_full, void* s_hi,
                              void* s_lo, void* partial, int n_nodes,
                              int n_rows, int T, int hdim, int n_slots,
                              int passes, int den_round,
                              void* stream) {
  const long long n_entries = (long long)n_nodes * T;
  if (n_nodes < 1 || n_rows < 1 || T < 1 || hdim < 1 || hdim % 4 != 0 ||
      n_entries > INT_MAX ||
      n_slots != (int)((n_entries + RANK_MAX - 1) / RANK_MAX) ||
      den_round < 0 || den_round > 2 || (uintptr_t)bits % 8 != 0 ||
      (passes != 0 && passes != 1 && passes != 3) ||
      (passes == 3) != (s_lo != nullptr) || long_rows == nullptr ||
      (n_slots > 1 && (chunk_hi == nullptr ||
                       (passes == 3) != (chunk_lo != nullptr) ||
                       (passes != 0) != (chunk_full != nullptr))) ||
      (proj == nullptr) == (bits == nullptr) ||
      (uintptr_t)dagg % 16 != 0 || (uintptr_t)proj % 16 != 0 ||
      (uintptr_t)chunk_hi % 16 != 0 || (uintptr_t)chunk_lo % 16 != 0 ||
      (uintptr_t)chunk_full % 16 != 0 ||
      (uintptr_t)s_hi % 16 != 0 || (uintptr_t)s_lo % 16 != 0 ||
      (uintptr_t)partial % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto* cc = (float*)c;
  auto* longs = (int*)long_rows;
  const auto st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(longs + n_rows, 0, 4, st);
  if (err != cudaSuccess) return (int)err;
  weights_kernel<<<csr_blocks(std::max(n_nodes, n_rows)), CSR_THREADS, 0,
                   st>>>((const float*)w, n_nodes, T, den_round, cc,
                         (const int*)offsets, n_rows, longs);
  const TableArgs a{(const int*)offsets,  (const int*)entries,
                    cc,                   (const float*)dagg,
                    (const float*)proj,   (const uint32_t*)bits,
                    longs,                (float*)chunk_hi,
                    (float*)chunk_lo,     (float*)chunk_full,
                    (float*)s_hi,         (float*)s_lo,
                    (float*)partial,      n_rows,
                    n_slots,              T,
                    hdim};
  err = passes == 0   ? launch_passes<0>(a, st)
        : passes == 1 ? launch_passes<1>(a, st)
                      : launch_passes<3>(a, st);
  return (int)err;
}

// The frontier form, where entry e of the weights w [B, T] is table row e
// (N = B T): S [B*T, H] (and its lo part in three passes) and the dbq
// partials [ceil(B / nodes_per_block), H] (ops/agg.py BWD_NODES), in one
// kernel, no CSR and no c; the rest as agg_bwd_launch's.
extern "C" int agg_bwd_frontier_launch(const void* w, const void* dagg,
                                       const void* proj, const void* bits,
                                       void* s_hi, void* s_lo,
                                       void* partial, int n_nodes, int T,
                                       int hdim, int nodes_per_block,
                                       int passes, int den_round,
                                       void* stream) {
  if (n_nodes < 1 || T < 1 || hdim < 1 || hdim % 4 != 0 ||
      nodes_per_block < 1 ||
      (long long)n_nodes * T > INT_MAX || den_round < 0 || den_round > 2 ||
      (uintptr_t)bits % 8 != 0 ||
      (passes != 0 && passes != 1 && passes != 3) ||
      (passes == 3) != (s_lo != nullptr) ||
      (proj == nullptr) == (bits == nullptr) ||
      (uintptr_t)dagg % 16 != 0 || (uintptr_t)proj % 16 != 0 ||
      (uintptr_t)s_hi % 16 != 0 || (uintptr_t)s_lo % 16 != 0 ||
      (uintptr_t)partial % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* ww = (const float*)w;
  const auto* d = (const float*)dagg;
  const auto* p = (const float*)proj;
  const auto* b = (const uint32_t*)bits;
  auto* hi = (float*)s_hi;
  auto* lo = (float*)s_lo;
  auto* part = (float*)partial;
  const auto st = (cudaStream_t)stream;
  const cudaError_t err =
      passes == 0   ? launch_frontier<0>(ww, d, p, b, hi, lo, part, n_nodes,
                                         T, hdim, den_round, nodes_per_block,
                                         st)
      : passes == 1 ? launch_frontier<1>(ww, d, p, b, hi, lo, part, n_nodes,
                                         T, hdim, den_round, nodes_per_block,
                                         st)
                    : launch_frontier<3>(ww, d, p, b, hi, lo, part, n_nodes,
                                         T, hdim, den_round, nodes_per_block,
                                         st);
  return (int)err;
}

extern "C" const char* agg_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
