// K3: fused neighbor gather + Q-MLP + importance-weighted mean on Hopper's
// tensor cores (sm_90a), one block per (node tile, column tile).
//
// Replaces the Pallas TPU kernel gcn_song_embeddings_tpu/ops/pallas_agg.py
// `_dma_agg_kernel` (entry `dma_gather_aggregate`).  Same function as K2
// (csrc/agg.cu):
//     agg[b] = sum_t w[b,t] * leaky_relu(h[nb[b,t]] . Wq^T + bq)
//              / (sum_t w[b,t], or 1 where that sum is 0)
// for h [N, Din] f32, nb [B, T] int32, w [B, T] f32, Wq [H, Din], bq [H].
// What carries over from the TPU kernel: the gathered rows of the next
// piece of work are in flight while the current one multiplies.
//
// What bounds it on the H100: the tensor cores.  On the train step's
// frontier forward (4,224 nodes x T = 10 at Din = H = 512, 384 x 10 at Din
// 128) the gathered rows are mostly distinct, 22.7 GFLOP of products; kept
// at f32 accuracy by 3xTF32 (csrc/agg_tc.cuh), that is 3 x 22.7 GFLOP at
// 495 TFLOP/s = 0.137 ms, against 87 MB of rows (0.026 ms at 3.35 TB/s).
//
// Design.  A block owns whole nodes, floor(192 / T) of them (190 rows of
// 192 at T = 10), and BN = 128 output columns, so every node's mean ends
// in the block.  It loads the tile's neighbour ids and weights, runs the
// shared 3xTF32 core (`agg_tc::tile_product`: gathered rows staged by
// 16-byte cp.async into a shared-memory ring, split in registers; Wq's
// pre-split, pre-swizzled tiles; wgmma.m64n128k8 over three warpgroups),
// then the epilogue through shared memory that reuses the ring: + bq,
// leaky_relu slope 0.01, x w, the sum over the node's T rows and the
// guarded divide.  Blocks of one node tile are adjacent in launch order,
// so the H / 128 column tiles that re-read the same gathered rows find
// them in L2.  Rows past the batch are zero-filled, not stored.
//
// The 16-bit forms (train.dtype "bfloat16" or "float16": layer 0 of
// the frontier train step reads the 16-bit feature table) take h and Wq
// in bf16 or f16 (Wq tiled by `wq_tile16_kernel`, no split), bq and the
// weights f32, out f32; one pass per product, exact in f32.  Their bound
// at the step's layer 0 (4,224 nodes x T = 10, Din = H = 512): 22.7
// GFLOP at 989 TFLOP/s = 0.023 ms against 43 MB of 16-bit rows (0.013
// ms), so the tensor cores bound it.  `dma_agg16_kernel` runs the 16-bit
// core of agg_tc.cuh (`run16`): a block pair takes a pair of 64-row tiles
// and sweeps a run of Wq's 128-column tiles over them, the tiles' rows
// gathered once into shared memory and kept there for the run (Din <=
// 896), while two consumer warpgroups take alternate tiles (m64n128k16
// from shared memory, each k chunk's partial sum promoted to an f32 sum
// on the CUDA cores), so one tile's epilogue runs under the other
// warpgroup's products; block pairs share Wq's chunks by multicast.  A
// tile holds whole nodes, floor(64 / T) of them (60 rows at T = 10).
// Its epilogue keeps K3's order: + bq, leaky_relu 0.01, x w, the sum
// over the node's T rows (through the warpgroup's shared memory, 64
// columns a pass), then the guarded divide; the tile's weights and bq
// are prefetched a tile ahead.  It takes any ids in [0, N), T <= 64 and
// any B: no branch for the frontier's contiguous ids.  What the H100
// shows of the steps: with two consumer warpgroups on one 128-row tile
// the tensor cores idled through every epilogue and K3-bf16 stayed
// slower than its gather + einsum yardstick; with the tiles alternating
// it went below it; the promoted sums cost time back (PERF.md, the
// kernel table).
//
// The bf16x forms (`dma_agg_launch_bf16x`) are the precision policy's
// (GCN_TPU_MATMUL_PRECISION default / high: the JAX package's train-step
// products on the TPU, one bf16 pass or three).  They take the f32 table
// as it is, with no bf16 copy, on the same core: its stager warps load
// each gathered row's k chunks into registers a chunk ahead and round
// them to bf16 (F32_X1), or split them into bf16 hi and lo (F32_X3: hi*lo
// + lo*hi + hi*hi against Wq's hi and lo tiles, two slots a chunk, rows
// resident to Din 448), into shared memory, so a row is read and rounded
// once a run of column tiles.  Bound at co1_T10_wide's step (4,224 x 10
// rows at Din 128, 384 x 10 at Din 256, H 1024): one pass 13.1 GFLOP at
// 989 TFLOP/s = 0.013 ms against 25.6 MB of f32 rows (0.008 ms), the
// tensor cores; at the 100k step's layer 0 (4,224 x 10 at Din 512, H 512)
// one pass 22.7 GFLOP, 0.023 ms, against 87 MB of rows, 0.026 ms, bytes;
// three passes 68 GFLOP, 0.069 ms, the tensor cores.  What bounds the
// one-pass form at the wide step on the H100 is the epilogue beside the
// tensor cores (PERF.md): its shared-memory traffic competes with their
// operand reads.
//
// The slope residual (template flag SLOPES, set where the aggregation's
// backward will run: ops/agg.py ConvAggregate): the epilogue also stores
// q >= 0 of each gathered entry and column as bits, which csrc/agg_bwd.cu
// reads as the leaky_relu's slopes (B*T*H / 8 bytes, 2.7 MB at the
// frontier step's layer 0).  A thread's fragment holds, of each of its
// two rows, columns 8 i + 2 (t % 4) and + 1 of the tile's 128 for i < 16:
// 32 columns, which it packs as the epilogue computes their q (bit 2 i +
// j for column 8 i + 2 (t % 4) + j) and stores as one word, word 4 ct +
// t % 4 of the entry's row of 4 ceil(H / 128) words (ct the column
// tile): the fragment's own layout, no shuffles and two stores a thread
// a tile.  With the flag off the kernels compile to what they were
// without it.

#include "agg_tc.cuh"

using namespace agg_tc;

constexpr int QS_LD = BN + 4;
constexpr int SMEM_BYTES = SMEM_ALIGN_SLACK + RING_BYTES + 3 * BM * 4;
constexpr int MAX_T16 = 64;

static_assert(BM * QS_LD * 4 <= RING_BYTES, "epilogue tile must fit the ring");

// The slope bit of fragment column i, half j (the (j + 1)-th column of
// the pair): where it sits in the thread's word of its row
__device__ __forceinline__ uint32_t slope_bit(float q, int i, int j) {
  return (q >= 0.f ? 1u : 0u) << (2 * i + j);
}

// A thread's two words of slope bits (rows frag_row(t, half)) into
// `slopes` [B*T][4 n_col_tiles], for the tile's rows below `tile_rows`
// (of entries g0..) and its column tile ct
__device__ __forceinline__ void store_slopes(const uint32_t* bits, int t,
                                             uint32_t* __restrict__ slopes,
                                             size_t g0, int tile_rows,
                                             int ct, int n_col_tiles) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = frag_row(t, half);
    if (r < tile_rows)
      slopes[(g0 + r) * 4 * n_col_tiles + 4 * ct + t % 4] = bits[half];
  }
}

template <bool SLOPES>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dma_agg_kernel(const float* __restrict__ h,      // [N, Din]
               const int* __restrict__ nb,       // [B, T]
               const float* __restrict__ w,      // [B, T]
               const float* __restrict__ big_t,  // Wq big, tiled
               const float* __restrict__ small_t,
               const float* __restrict__ bq,     // [H]
               float* __restrict__ out,          // [B, H]
               uint32_t* __restrict__ slopes,    // SLOPES: [B*T][4 col tiles]
               int n_nodes, int T, int din, int hdim, int nodes_per_tile,
               int n_col_tiles) {
  extern __shared__ unsigned char smem_raw[];
  float* ring = aligned_ring(smem_raw);
  int* rows_s = reinterpret_cast<int*>(ring + RING_BYTES / 4);
  float* w_s = reinterpret_cast<float*>(rows_s + BM);
  float* denom_s = w_s + BM;

  const int tid = threadIdx.x;
  const int col_tile = blockIdx.x % n_col_tiles;
  const int b0 = (blockIdx.x / n_col_tiles) * nodes_per_tile;
  const int n0 = col_tile * BN;
  const int tile_nodes = min(nodes_per_tile, n_nodes - b0);
  const int tile_rows = tile_nodes * T;
  const size_t g0 = (size_t)b0 * T;

  if (tid < BM) {
    rows_s[tid] = tid < tile_rows ? nb[g0 + tid] : -1;
    w_s[tid] = tid < tile_rows ? w[g0 + tid] : 0.f;
  }
  __syncthreads();
  if (tid < tile_nodes) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += w_s[tid * T + t];
    denom_s[tid] = (s == 0.f) ? 1.f : s;
  }

  float acc[64];
  tile_product(acc, ring, rows_s, h, din, big_t, small_t, col_tile);

  // epilogue 1: weighted activations of every row into Qs (the ring is
  // free: tile_product ended on a barrier after its last product)
  float* Qs = ring;
  uint32_t bits[2] = {0u, 0u};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = frag_row(tid, half);
    const float wr = w_s[r];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = frag_col(tid, i);
      const float b0v = (n0 + c < hdim) ? bq[n0 + c] : 0.f;
      const float b1v = (n0 + c + 1 < hdim) ? bq[n0 + c + 1] : 0.f;
      float q0 = acc[4 * i + 2 * half] + b0v;
      float q1 = acc[4 * i + 2 * half + 1] + b1v;
      if constexpr (SLOPES)
        bits[half] |= slope_bit(q0, i, 0) | slope_bit(q1, i, 1);
      q0 = (q0 >= 0.f) ? q0 : 0.01f * q0;
      q1 = (q1 >= 0.f) ? q1 : 0.01f * q1;
      *reinterpret_cast<float2*>(Qs + r * QS_LD + c) =
          make_float2(wr * q0, wr * q1);
    }
  }
  if constexpr (SLOPES)
    store_slopes(bits, tid, slopes, g0, tile_rows, col_tile, n_col_tiles);
  __syncthreads();

  // epilogue 2: sum each node's T rows, guarded divide, coalesced store
  for (int p = tid; p < tile_nodes * BN; p += THREADS) {
    const int node = p / BN, c = p % BN;
    if (n0 + c >= hdim) continue;
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += Qs[(node * T + t) * QS_LD + c];
    out[(size_t)(b0 + node) * hdim + n0 + c] = s / denom_s[node];
  }
}

// ---- the 16-bit form ------------------------------------------------------

// Row r of tile `tile`: the r-th gathered id of its node tile, -1 past it
struct NodeTileRows {
  const int* nb;
  int n_nodes, T, nodes_per_tile, n_col_tiles;
  __device__ __forceinline__ int operator()(int tile, int r) const {
    const int b0 = (tile / n_col_tiles) * nodes_per_tile;
    const int tile_rows = min(nodes_per_tile, n_nodes - b0) * T;
    return r < tile_rows ? nb[(size_t)b0 * T + r] : -1;
  }
};

// K3's epilogue on one warpgroup's accumulator fragment, 64 columns a
// pass through its shared memory (warpgroup wg's area at wg_smem + wg *
// WG_BYTES16): + bq, leaky_relu, x w, the sum over each node's T rows,
// the guarded divide.  The tile's weights and bq are prefetched while it
// multiplies.
template <bool SLOPES>
struct NodeMeanEpilogue {
  const float* w;
  const float* bq;
  float* out;
  uint32_t* slopes;                 // SLOPES: [B*T][4 col tiles]
  unsigned char* wg_smem;
  int n_nodes, T, hdim, nodes_per_tile, n_col_tiles;
  __device__ __forceinline__ void prefetch(int tile, int wg) const {
    const int t = threadIdx.x % 128;
    unsigned char* mine = wg_smem + wg * WG_BYTES16;
    const int b0 = (tile / n_col_tiles) * nodes_per_tile;
    const int tile_rows = min(nodes_per_tile, n_nodes - b0) * T;
    if (t < BM16) {
      const bool ok = t < tile_rows;
      cp_async4(mine + W16 + 4 * t, ok ? w + (size_t)b0 * T + t : w,
                ok ? 4 : 0);
    }
    prefetch_bq16(reinterpret_cast<float*>(mine + BQ16), bq,
                  (tile % n_col_tiles) * BN16, hdim);
    cp_async_commit();
  }
  __device__ __forceinline__ void operator()(int tile, float* acc,
                                             int wg) const {
    const int t = threadIdx.x % 128;
    unsigned char* mine = wg_smem + wg * WG_BYTES16;
    float* epi = reinterpret_cast<float*>(mine + EPI16);
    const float* bq_s = reinterpret_cast<const float*>(mine + BQ16);
    const float* w_s = reinterpret_cast<const float*>(mine + W16);
    float* den_s = reinterpret_cast<float*>(mine + DEN16);
    const int b0 = (tile / n_col_tiles) * nodes_per_tile;
    const int n0 = (tile % n_col_tiles) * BN16;
    const int tile_nodes = min(nodes_per_tile, n_nodes - b0);
    cp_async_wait<0>();
    consumer_sync(wg);
    if (t < tile_nodes) {
      float s = 0.f;
      for (int r = 0; r < T; ++r) s += w_s[t * T + r];
      den_s[t] = (s == 0.f) ? 1.f : s;
    }
    const float wr[2] = {w_s[frag_row(t, 0)], w_s[frag_row(t, 1)]};
    uint32_t bits[2] = {0u, 0u};
#pragma unroll
    for (int pass = 0; pass < BN16 / EPI_COLS16; ++pass) {
      if (n0 + pass * EPI_COLS16 >= hdim) break;    // the same for all
#pragma unroll
      for (int ii = 0; ii < EPI_COLS16 / 8; ++ii) {
        const int i = pass * (EPI_COLS16 / 8) + ii;
        const int cl = 8 * ii + 2 * (t % 4);       // column in the pass
        const float2 b = *reinterpret_cast<const float2*>(
            bq_s + frag_col(t, i));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float q0 = acc[4 * i + 2 * half] + b.x;
          float q1 = acc[4 * i + 2 * half + 1] + b.y;
          if constexpr (SLOPES)
            bits[half] |= slope_bit(q0, i, 0) | slope_bit(q1, i, 1);
          q0 = (q0 >= 0.f) ? q0 : 0.01f * q0;
          q1 = (q1 >= 0.f) ? q1 : 0.01f * q1;
          *reinterpret_cast<float2*>(epi + frag_row(t, half) * EPI_LD16 +
                                     cl) =
              make_float2(wr[half] * q0, wr[half] * q1);
        }
      }
      consumer_sync(wg);
      // a warp per node, a column pair per lane; two nodes 4 apart at a
      // time, so their loads are in flight together
      const int pair = 2 * (t % 32);
      const int c = n0 + pass * EPI_COLS16 + pair;   // H % 4 == 0: c + 1 too
      for (int node = t / 32; node < tile_nodes; node += 2 * 4) {
        const int other = node + 4;
        const bool two = other < tile_nodes;
        const float* r0 = epi + node * T * EPI_LD16 + pair;
        const float* r1 = epi + (two ? other : node) * T * EPI_LD16 + pair;
        float2 s0 = make_float2(0.f, 0.f), s1 = s0;
#pragma unroll 4
        for (int r = 0; r < T; ++r) {
          const float2 v0 =
              *reinterpret_cast<const float2*>(r0 + r * EPI_LD16);
          const float2 v1 =
              *reinterpret_cast<const float2*>(r1 + r * EPI_LD16);
          s0.x += v0.x;
          s0.y += v0.y;
          s1.x += v1.x;
          s1.y += v1.y;
        }
        if (c < hdim) {
          const float d0 = den_s[node];
          *reinterpret_cast<float2*>(out + (size_t)(b0 + node) * hdim + c) =
              make_float2(s0.x / d0, s0.y / d0);
          if (two) {
            const float d1 = den_s[other];
            *reinterpret_cast<float2*>(out + (size_t)(b0 + other) * hdim +
                                       c) = make_float2(s1.x / d1, s1.y / d1);
          }
        }
      }
      consumer_sync(wg);
    }
    if constexpr (SLOPES)
      store_slopes(bits, t, slopes, (size_t)b0 * T, tile_nodes * T,
                   tile % n_col_tiles, n_col_tiles);
  }
};

// The 16-bit forms: SRC TABLE16 (h bf16 / f16, F16), F32_X1 / F32_X3 (h
// f32, rounded to bf16 or split into hi and lo as it is staged; wq_lo_t:
// Wq's lo tiles for three passes)
template <bool F16, int SRC, bool SLOPES>
__global__ void __launch_bounds__(THREADS16, 1) __cluster_dims__(CLUSTER16, 1, 1)
dma_agg16_kernel(const void* __restrict__ h,       // [N, Din]
                 const int* __restrict__ nb,       // [B, T]
                 const float* __restrict__ w,      // [B, T]
                 const uint16_t* __restrict__ wq_t,  // Wq, tiled
                 const uint16_t* __restrict__ wq_lo_t,
                 const float* __restrict__ bq,     // [H]
                 float* __restrict__ out,          // [B, H]
                 uint32_t* __restrict__ slopes,    // SLOPES: [B*T][4 col tiles]
                 int n_nodes, int T, int din, int hdim, int nodes_per_tile,
                 int n_col_tiles, int n_row_tiles, int groups,
                 int resident) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      aligned_ring(smem_raw));
  const NodeTileRows rows{nb, n_nodes, T, nodes_per_tile, n_col_tiles};
  const NodeMeanEpilogue<SLOPES> epilogue{
      w, bq, out, slopes, smem + WG_OFF16, n_nodes, T, hdim, nodes_per_tile,
      n_col_tiles};
  run16<F16, SRC>(smem, h, din, wq_t, wq_lo_t, n_col_tiles, n_row_tiles,
                  groups, resident, rows, epilogue);
}

static long long node_row_tiles(int n_nodes, int T) {
  const int nodes_per_tile = BM16 / T;
  return (n_nodes + nodes_per_tile - 1) / nodes_per_tile;
}

// One 16-bit form of K3 on a checked problem: the persistent grid of
// block pairs over `schedule16`'s items (SLOPES: the slope bits too)
template <bool F16, int SRC, bool SLOPES>
static cudaError_t launch_core16(const void* h, const void* nb,
                                 const void* w, const void* tiles,
                                 const void* lo_tiles, const void* bq,
                                 void* out, void* slopes, int n_nodes, int T,
                                 int din, int hdim, cudaStream_t stream) {
  const long long n_row_tiles = node_row_tiles(n_nodes, T);
  Schedule16 sc;
  const cudaError_t err =
      schedule16(dma_agg16_kernel<F16, SRC, SLOPES>, din, hdim,
                 SRC == F32_X3 ? 2 : 1, n_row_tiles, &sc);
  if (err != cudaSuccess) return err;
  dma_agg16_kernel<F16, SRC, SLOPES>
      <<<sc.blocks, THREADS16, SMEM16, stream>>>(
          h, (const int*)nb, (const float*)w, (const uint16_t*)tiles,
          (const uint16_t*)lo_tiles, (const float*)bq, (float*)out,
          (uint32_t*)slopes, n_nodes, T, din, hdim, BM16 / T,
          (hdim + BN16 - 1) / BN16, (int)n_row_tiles, sc.groups,
          sc.resident);
  return cudaGetLastError();
}

template <bool F16, int SRC>
static cudaError_t launch_form16(const void* h, const void* nb,
                                 const void* w, const void* tiles,
                                 const void* lo_tiles, const void* bq,
                                 void* out, void* slopes, int n_nodes, int T,
                                 int din, int hdim, cudaStream_t stream) {
  return slopes ? launch_core16<F16, SRC, true>(h, nb, w, tiles, lo_tiles, bq,
                                                out, slopes, n_nodes, T, din,
                                                hdim, stream)
                : launch_core16<F16, SRC, false>(h, nb, w, tiles, lo_tiles,
                                                 bq, out, slopes, n_nodes, T,
                                                 din, hdim, stream);
}

template <bool SLOPES>
static cudaError_t launch_f32(const void* h, const void* nb, const void* w,
                              const void* big_t, const void* small_t,
                              const void* bq, void* out, void* slopes,
                              int n_nodes, int T, int din, int hdim,
                              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dma_agg_kernel<SLOPES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int nodes_per_tile = BM / T;
  const int n_col_tiles = (hdim + BN - 1) / BN;
  const long long n_node_tiles =
      (n_nodes + nodes_per_tile - 1) / nodes_per_tile;
  const unsigned blocks = (unsigned)(n_node_tiles * n_col_tiles);
  dma_agg_kernel<SLOPES><<<blocks, THREADS, SMEM_BYTES, stream>>>(
      (const float*)h, (const int*)nb, (const float*)w, (const float*)big_t,
      (const float*)small_t, (const float*)bq, (float*)out,
      (uint32_t*)slopes, n_nodes, T, din, hdim, nodes_per_tile, n_col_tiles);
  return cudaGetLastError();
}

// `slopes` (nullptr: none) takes the slope bits [B*T][4 ceil(H/128)] of
// each entry (4-byte aligned), in every form below

extern "C" int dma_agg_launch(const void* h, const void* nb, const void* w,
                              const void* big_t, const void* small_t,
                              const void* bq, void* out, void* slopes,
                              int n_nodes, int T, int din, int hdim,
                              void* stream) {
  if (T < 1 || T > BM || din < 1 || hdim < 1 || din % 4 != 0 ||
      hdim % 4 != 0 || (uintptr_t)h % 16 != 0 || (uintptr_t)big_t % 16 != 0 ||
      (uintptr_t)small_t % 16 != 0 || (uintptr_t)slopes % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_nodes < 1) return (int)cudaSuccess;
  const auto st = (cudaStream_t)stream;
  return (int)(slopes ? launch_f32<true>(h, nb, w, big_t, small_t, bq, out,
                                         slopes, n_nodes, T, din, hdim, st)
                      : launch_f32<false>(h, nb, w, big_t, small_t, bq, out,
                                          slopes, n_nodes, T, din, hdim, st));
}

// f16 != 0: h and the tiles are f16, else bf16
extern "C" int dma_agg_launch16(const void* h, const void* nb, const void* w,
                                const void* tiles, const void* bq, void* out,
                                void* slopes, int n_nodes, int T, int din,
                                int hdim, int f16, void* stream) {
  if (T < 1 || T > MAX_T16 || din < 1 || hdim < 1 || din % 8 != 0 ||
      hdim % 4 != 0 || (uintptr_t)h % 16 != 0 || (uintptr_t)tiles % 16 != 0 ||
      (uintptr_t)out % 8 != 0 || (uintptr_t)slopes % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_nodes < 1) return (int)cudaSuccess;
  return (int)(f16 ? launch_form16<true, TABLE16>(
                         h, nb, w, tiles, nullptr, bq, out, slopes, n_nodes,
                         T, din, hdim, (cudaStream_t)stream)
                   : launch_form16<false, TABLE16>(
                         h, nb, w, tiles, nullptr, bq, out, slopes, n_nodes,
                         T, din, hdim, (cudaStream_t)stream));
}

// h f32, rounded to bf16 as it is staged: passes 1 (hi tiles only) or 3
// (hi and lo tiles of Wq, from agg_tile_bf16x_launch)
extern "C" int dma_agg_launch_bf16x(const void* h, const void* nb,
                                    const void* w, const void* hi,
                                    const void* lo, const void* bq, void* out,
                                    void* slopes, int n_nodes, int T, int din,
                                    int hdim, int passes, void* stream) {
  if (T < 1 || T > MAX_T16 || din < 1 || hdim < 1 || din % 8 != 0 ||
      hdim % 4 != 0 || (passes != 1 && passes != 3) ||
      (passes == 3) != (lo != nullptr) || (uintptr_t)h % 16 != 0 ||
      (uintptr_t)hi % 16 != 0 || (uintptr_t)lo % 16 != 0 ||
      (uintptr_t)out % 8 != 0 || (uintptr_t)slopes % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_nodes < 1) return (int)cudaSuccess;
  return (int)(passes == 1 ? launch_form16<false, F32_X1>(
                                 h, nb, w, hi, nullptr, bq, out, slopes,
                                 n_nodes, T, din, hdim, (cudaStream_t)stream)
                           : launch_form16<false, F32_X3>(
                                 h, nb, w, hi, lo, bq, out, slopes, n_nodes,
                                 T, din, hdim, (cudaStream_t)stream));
}

// The grid the 16-bit core takes for a problem (n_nodes >= 1) of
// `passes` (0: a 16-bit table, 1 or 3 bf16 passes) on this card: sc =
// {resident, groups, items, clusters, blocks}
extern "C" int dma_agg_schedule(int n_nodes, int T, int din, int hdim,
                                int passes, int* sc) {
  if (n_nodes < 1 || T < 1 || T > MAX_T16 || din < 1 || hdim < 1 ||
      (passes != 0 && passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  Schedule16 x;
  const long long rows = node_row_tiles(n_nodes, T);
  const cudaError_t err =
      passes == 0   ? schedule16(dma_agg16_kernel<false, TABLE16, false>, din,
                                 hdim, 1, rows, &x)
      : passes == 1 ? schedule16(dma_agg16_kernel<false, F32_X1, false>, din,
                                 hdim, 1, rows, &x)
                    : schedule16(dma_agg16_kernel<false, F32_X3, false>, din,
                                 hdim, 2, rows, &x);
  if (err != cudaSuccess) return (int)err;
  const int v[5] = {x.resident, x.groups, x.items, x.clusters, x.blocks};
  for (int i = 0; i < 5; ++i) sc[i] = v[i];
  return (int)cudaSuccess;
}

extern "C" const char* dma_agg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
