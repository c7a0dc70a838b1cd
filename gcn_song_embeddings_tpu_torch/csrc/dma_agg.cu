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
// The bf16 form (train.dtype="bfloat16": layer 0 of the frontier train
// step reads the bf16 feature table) is the same kernel on the bf16 core
// of agg_tc.cuh: h and Wq in bf16 (Wq tiled by `wq_tile_bf16_kernel`,
// no split), bq and the weights f32, out f32; one bf16 pass per product,
// exact in f32.  Its bound at the step's layer 0 (4,224 nodes x T = 10,
// Din = H = 512): 22.7 GFLOP at 989 TFLOP/s of bf16 = 0.023 ms against
// 43 MB of bf16 rows (0.013 ms), so the tensor cores bound it.

#include "agg_tc.cuh"

using namespace agg_tc;

constexpr int QS_LD = BN + 4;
constexpr int SMEM_BYTES = SMEM_ALIGN_SLACK + RING_BYTES + 3 * BM * 4;
constexpr int SMEM_BYTES16 = SMEM_ALIGN_SLACK + RING_BYTES16 + 3 * BM * 4;

static_assert(BM * QS_LD * 4 <= RING_BYTES, "epilogue tile must fit the ring");
static_assert(BM * QS_LD * 4 <= RING_BYTES16, "epilogue tile must fit the ring");

// E = float: the 3xTF32 core, Wq as its big and small parts; E = uint16_t
// (bf16 bits): the bf16 core, Wq tiled in big_t, small_t unused
template <typename E>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dma_agg_kernel(const E* __restrict__ h,          // [N, Din]
               const int* __restrict__ nb,       // [B, T]
               const float* __restrict__ w,      // [B, T]
               const E* __restrict__ big_t,      // Wq big, tiled
               const E* __restrict__ small_t,
               const float* __restrict__ bq,     // [H]
               float* __restrict__ out,          // [B, H]
               int n_nodes, int T, int din, int hdim, int nodes_per_tile,
               int n_col_tiles) {
  constexpr bool BF16 = sizeof(E) == 2;
  extern __shared__ unsigned char smem_raw[];
  float* ring = aligned_ring(smem_raw);
  int* rows_s = reinterpret_cast<int*>(
      ring + (BF16 ? RING_BYTES16 : RING_BYTES) / 4);
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
  if constexpr (BF16)
    tile_product_bf16(acc, ring, rows_s, h, din, big_t, col_tile);
  else
    tile_product(acc, ring, rows_s, h, din, big_t, small_t, col_tile);

  // epilogue 1: weighted activations of every row into Qs (the ring is
  // free: tile_product ended on a barrier after its last product)
  float* Qs = ring;
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
      q0 = (q0 >= 0.f) ? q0 : 0.01f * q0;
      q1 = (q1 >= 0.f) ? q1 : 0.01f * q1;
      *reinterpret_cast<float2*>(Qs + r * QS_LD + c) =
          make_float2(wr * q0, wr * q1);
    }
  }
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

extern "C" int dma_agg_launch(const void* h, const void* nb, const void* w,
                              const void* big_t, const void* small_t,
                              const void* bq, void* out, int n_nodes, int T,
                              int din, int hdim, void* stream) {
  if (T < 1 || T > BM || din < 1 || hdim < 1 || din % 4 != 0 ||
      hdim % 4 != 0 || (uintptr_t)h % 16 != 0 || (uintptr_t)big_t % 16 != 0 ||
      (uintptr_t)small_t % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_nodes < 1) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      dma_agg_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int nodes_per_tile = BM / T;
  const int n_col_tiles = (hdim + BN - 1) / BN;
  const long long n_node_tiles =
      (n_nodes + nodes_per_tile - 1) / nodes_per_tile;
  const unsigned blocks = (unsigned)(n_node_tiles * n_col_tiles);
  dma_agg_kernel<float>
      <<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
          (const float*)h, (const int*)nb, (const float*)w,
          (const float*)big_t, (const float*)small_t, (const float*)bq,
          (float*)out, n_nodes, T, din, hdim, nodes_per_tile, n_col_tiles);
  return (int)cudaGetLastError();
}

extern "C" int dma_agg_bf16_launch(const void* h, const void* nb,
                                   const void* w, const void* tiles,
                                   const void* bq, void* out, int n_nodes,
                                   int T, int din, int hdim, void* stream) {
  if (T < 1 || T > BM || din < 1 || hdim < 1 || din % 8 != 0 ||
      hdim % 4 != 0 || (uintptr_t)h % 16 != 0 || (uintptr_t)tiles % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_nodes < 1) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      dma_agg_kernel<uint16_t>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES16);
  if (err != cudaSuccess) return (int)err;
  const int nodes_per_tile = BM / T;
  const int n_col_tiles = (hdim + BN - 1) / BN;
  const long long n_node_tiles =
      (n_nodes + nodes_per_tile - 1) / nodes_per_tile;
  const unsigned blocks = (unsigned)(n_node_tiles * n_col_tiles);
  dma_agg_kernel<uint16_t>
      <<<blocks, THREADS, SMEM_BYTES16, (cudaStream_t)stream>>>(
          (const uint16_t*)h, (const int*)nb, (const float*)w,
          (const uint16_t*)tiles, nullptr, (const float*)bq, (float*)out,
          n_nodes, T, din, hdim, nodes_per_tile, n_col_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* dma_agg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
