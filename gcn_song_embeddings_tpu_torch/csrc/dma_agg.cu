// K3: fused neighbor gather + Q-MLP + importance-weighted mean, with the
// gathered rows brought in by explicit row copies (TMA bulk copies) into a
// two-stage shared-memory ring, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gcn_song_embeddings_tpu/ops/pallas_agg.py
// `_dma_agg_kernel` (entry `dma_gather_aggregate`).  Same function as K2
// (csrc/agg.cu):
//     agg[b] = sum_t w[b,t] * leaky_relu(h[nb[b,t]] . Wq^T + bq)
//              / (sum_t w[b,t], or 1 where that sum is 0)
// for h [N, Din] f32, nb [B, T] int32, w [B, T] f32, Wq [H, Din], bq [H].
// The TPU kernel's schedule is what carries over: all gathered rows of the
// next piece of work are copied by one explicit copy per row while the
// current piece multiplies, into a double buffer whose halves each signal
// their own completion.
//
// What bounds it on the H100: arithmetic.  On the train step's frontier
// forward (B = 4224 nodes x T = 10, Din = H = 512) the gathered rows are
// mostly distinct, so the function needs 2*B*T*Din*H = 22 GFLOP against
// 87 MB of rows: 250 FLOP per byte, past the card's f32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 FLOP per byte).  The copies are there to keep the
// FMA pipes fed while the scattered 2 KB rows are in flight.
//
// Design.  A block owns BN = 128 output columns and walks over node tiles
// of BM = 64 gathered rows (the T rows of floor(64 / T) nodes, so every
// node's mean finishes inside the block).  Din is cut into chunks of
// BK = 64.  A "piece" is one (node tile, Din chunk) pair; the block's
// pieces form one sequence, and piece j lives in stage j % 2 of the ring:
//   - stage = A chunk [BM][BK] of gathered rows (row stride BK + 4 floats,
//     so the two row groups a warp reads sit 16 banks apart) + B chunk
//     [BK][BN] of Wq^T, 50,176 bytes; two stages fit twice per SM;
//   - warp 0 issues one `cp.async.bulk` global->shared copy per gathered
//     row segment and per Wq^T row segment of a piece; its lane 0 first
//     arms the stage's mbarrier with the piece's byte count (expect_tx),
//     and the copies' completion drains it;
//   - the block waits on piece j's mbarrier phase, multiplies it with
//     plain f32 FMAs (each thread a 4 x 8 tile of q in registers) while
//     piece j+1's copies are in flight, then refills the stage with piece
//     j+2.  So the next node tile's first rows are on their way while the
//     current tile finishes its last chunk and its epilogue.
// The epilogue (+bq, leaky_relu slope 0.01, times w, the sum over the
// node's T rows, the guarded divide) runs in the stage the tile's last
// chunk just used.  Rows past the batch are never copied (their stale
// shared memory only reaches rows that are not stored).  wgmma and warp
// specialisation are later work.
//
// Bulk copies need 16-byte aligned addresses and sizes that are multiples
// of 16 bytes: the wrapper guarantees Din % 4 == 0, H % 4 == 0 and a
// 16-byte aligned h and Wq^T.

#include <cuda_runtime.h>

#include <cstdint>

#define BM 64
#define BN 128
#define BK 64
#define TM 4
#define TN 8
#define THREADS 256
#define AS_LD (BK + 4)
#define STAGE_FLOATS (BM * AS_LD + BK * BN)
#define STAGE_BYTES (STAGE_FLOATS * 4)
#define QS_LD (BN + 1)
#define SMEM_BYTES (2 * STAGE_BYTES + 2 * 8 + BM * 4)

static_assert(BM * QS_LD <= STAGE_FLOATS, "epilogue tile must fit a stage");
static_assert((AS_LD * 4) % 16 == 0, "row segments must stay 16B aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait that
// outlasts any real copy by orders of magnitude (2^26 polls) traps, so a
// broken protocol ends the launch with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one global -> shared bulk copy whose completion goes to `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Work {
  int n_nodes, T, din, hdim, nodes_per_tile, n_node_tiles, n_chunks;
  int tile0, tile_stride, n0, ncols;

  __device__ int tile_of(int j) const {
    return tile0 + (j / n_chunks) * tile_stride;
  }
  __device__ int tile_nodes(int tile) const {
    return min(nodes_per_tile, n_nodes - tile * nodes_per_tile);
  }
};

// Every thread's reads (and, in an epilogue, writes) of a stage went
// through the generic proxy; order them before the async proxy's copies
// into it, then meet at the barrier.
__device__ __forceinline__ void release_stage() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

// Warp 0 issues piece j's copies into `stage` (called by warp 0 only).
__device__ __forceinline__ void issue_piece(
    const Work& wk, int j, float* stage, uint64_t* bar,
    const float* __restrict__ h, const int* __restrict__ nb,
    const float* __restrict__ wqT, int lane) {
  const int tile = wk.tile_of(j);
  const int k0 = (j % wk.n_chunks) * BK;
  const int klen = min(BK, wk.din - k0);
  const int rows = wk.tile_nodes(tile) * wk.T;
  const size_t g0 = (size_t)tile * wk.nodes_per_tile * wk.T;
  if (lane == 0)
    mbar_arrive_expect_tx(
        bar, (uint32_t)(rows * klen * 4 + klen * wk.ncols * 4));
  __syncwarp();
  float* As = stage;
  float* Bs = stage + BM * AS_LD;
  for (int r = lane; r < rows; r += 32) {
    const int row = nb[g0 + r];
    bulk_copy(As + r * AS_LD, h + (size_t)row * wk.din + k0,
              (uint32_t)(klen * 4), bar);
  }
  for (int kb = lane; kb < klen; kb += 32)
    bulk_copy(Bs + kb * BN, wqT + (size_t)(k0 + kb) * wk.hdim + wk.n0,
              (uint32_t)(wk.ncols * 4), bar);
}

__global__ void __launch_bounds__(THREADS, 2)
dma_agg_kernel(const float* __restrict__ h,     // [N, Din]
               const int* __restrict__ nb,      // [B, T]
               const float* __restrict__ w,     // [B, T]
               const float* __restrict__ wqT,   // [Din, H]
               const float* __restrict__ bq,    // [H]
               float* __restrict__ out,         // [B, H]
               int n_nodes, int T, int din, int hdim, int nodes_per_tile,
               int n_col_tiles, int tile_stride) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + 2 * STAGE_BYTES);
  float* denom_s = reinterpret_cast<float*>(bars + 2);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  Work wk;
  wk.n_nodes = n_nodes;
  wk.T = T;
  wk.din = din;
  wk.hdim = hdim;
  wk.nodes_per_tile = nodes_per_tile;
  wk.n_node_tiles = (n_nodes + nodes_per_tile - 1) / nodes_per_tile;
  wk.n_chunks = (din + BK - 1) / BK;
  const int col_tile = blockIdx.x % n_col_tiles;
  wk.tile0 = blockIdx.x / n_col_tiles;
  wk.tile_stride = tile_stride;
  wk.n0 = col_tile * BN;
  wk.ncols = min(BN, hdim - wk.n0);
  if (wk.tile0 >= wk.n_node_tiles) return;
  const int my_tiles =
      (wk.n_node_tiles - wk.tile0 + tile_stride - 1) / tile_stride;
  const int n_pieces = my_tiles * wk.n_chunks;

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    issue_piece(wk, 0, stages, &bars[0], h, nb, wqT, lane);
    if (n_pieces > 1)
      issue_piece(wk, 1, stages + STAGE_FLOATS, &bars[1], h, nb, wqT, lane);
  }

  // thread (tx, ty) owns rows ty*4 .. ty*4+3 and columns tx*4 .. tx*4+3,
  // 64+tx*4 .. 64+tx*4+3 (neighbouring threads read neighbouring float4s)
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int j = 0; j < n_pieces; ++j) {
    const int s = j & 1;
    float* stage = stages + s * STAGE_FLOATS;
    const int chunk = j % wk.n_chunks;
    const int klen = min(BK, din - chunk * BK);
    mbar_wait(&bars[s], (uint32_t)((j >> 1) & 1));

    const float* As = stage + ty * TM * AS_LD;
    const float* Bs = stage + BM * AS_LD;
    for (int k0 = 0; k0 < klen; k0 += 4) {
      float4 a4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a4[i] = *reinterpret_cast<const float4*>(As + i * AS_LD + k0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = Bs + (k0 + kk) * BN;
        const float4 bl = *reinterpret_cast<const float4*>(brow + tx * 4);
        const float4 bh =
            *reinterpret_cast<const float4*>(brow + 64 + tx * 4);
        const float bv[TN] = {bl.x, bl.y, bl.z, bl.w,
                              bh.x, bh.y, bh.z, bh.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = kk == 0   ? a4[i].x
                          : kk == 1 ? a4[i].y
                          : kk == 2 ? a4[i].z
                                    : a4[i].w;
#pragma unroll
          for (int jj = 0; jj < TN; ++jj)
            acc[i][jj] = fmaf(a, bv[jj], acc[i][jj]);
        }
      }
    }
    if (chunk == wk.n_chunks - 1)
      __syncthreads();  // every thread is done reading stage s
    else
      release_stage();

    if (chunk == wk.n_chunks - 1) {
      // epilogue of this node tile, through stage s
      const int tile = wk.tile_of(j);
      const int b0 = tile * nodes_per_tile;
      const int tile_nodes = wk.tile_nodes(tile);
      const int tile_rows = tile_nodes * T;
      const size_t g0 = (size_t)b0 * T;
      float* Qs = stage;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty * TM + i;
        const float wr = (r < tile_rows) ? w[g0 + r] : 0.f;
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          const int c = (jj < 4) ? tx * 4 + jj : 64 + tx * 4 + (jj - 4);
          const float bias = (wk.n0 + c < hdim) ? bq[wk.n0 + c] : 0.f;
          float q = acc[i][jj] + bias;
          q = (q >= 0.f) ? q : 0.01f * q;
          Qs[r * QS_LD + c] = wr * q;
          acc[i][jj] = 0.f;
        }
      }
      if (tid < tile_nodes) {
        float sum = 0.f;
        for (int t = 0; t < T; ++t) sum += w[g0 + tid * T + t];
        denom_s[tid] = (sum == 0.f) ? 1.f : sum;
      }
      __syncthreads();
      for (int p = tid; p < tile_nodes * BN; p += THREADS) {
        const int node = p / BN, c = p % BN;
        if (c >= wk.ncols) continue;
        float sum = 0.f;
        for (int t = 0; t < T; ++t) sum += Qs[(node * T + t) * QS_LD + c];
        out[(size_t)(b0 + node) * hdim + wk.n0 + c] = sum / denom_s[node];
      }
      release_stage();  // Qs and denom_s are free again
    }
    if (warp == 0 && j + 2 < n_pieces)
      issue_piece(wk, j + 2, stage, &bars[s], h, nb, wqT, lane);
  }
}

extern "C" int dma_agg_launch(const void* h, const void* nb, const void* w,
                              const void* wqT, const void* bq, void* out,
                              int n_nodes, int T, int din, int hdim,
                              void* stream) {
  if (T < 1 || T > BM || din < 1 || hdim < 1 || din % 4 != 0 ||
      hdim % 4 != 0 || (uintptr_t)h % 16 != 0 || (uintptr_t)wqT % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_nodes < 1) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      dma_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int device = 0, n_sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const int nodes_per_tile = BM / T;
  const int n_col_tiles = (hdim + BN - 1) / BN;
  const int n_node_tiles = (n_nodes + nodes_per_tile - 1) / nodes_per_tile;
  // two resident blocks per SM; each walks node tiles with this stride
  int tile_stride = (2 * n_sms) / n_col_tiles;
  if (tile_stride < 1) tile_stride = 1;
  if (tile_stride > n_node_tiles) tile_stride = n_node_tiles;
  const unsigned blocks = (unsigned)(tile_stride * n_col_tiles);
  dma_agg_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)h, (const int*)nb, (const float*)w, (const float*)wqT,
      (const float*)bq, (float*)out, n_nodes, T, din, hdim, nodes_per_tile,
      n_col_tiles, tile_stride);
  return (int)cudaGetLastError();
}

extern "C" const char* dma_agg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
