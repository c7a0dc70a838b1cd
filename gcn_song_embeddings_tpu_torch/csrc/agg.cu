// K2: fused neighbor gather + Q-MLP + importance-weighted mean, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel gcn_song_embeddings_tpu/ops/pallas_agg.py
// `_agg_kernel` (entry `fused_gather_aggregate`).  Same function:
//     agg[b] = sum_t w[b,t] * leaky_relu(h[nb[b,t]] . Wq^T + bq)
//              / (sum_t w[b,t], or 1 where that sum is 0)
// for h [N, Din] f32, nb [B, T] int32, w [B, T] f32, Wq [H, Din], bq [H],
// without materializing the [B*T, Din] gathered rows in device memory.
//
// What bounds it on the H100: arithmetic.  Each distinct row of h feeds
// 2*Din*H operations (Din=H=512: 256 FLOP per byte), far past the card's
// f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP per byte).  The function
// needs each distinct neighbor row projected once, 2*U*Din*H operations
// for U distinct ids; this kernel projects every one of the B*T gathered
// rows, so where ids repeat across nodes (the full-graph embed, B = N) it
// does about T times that work.  The row gather itself is scattered 2 KB
// reads that L2 absorbs.
//
// Design: a shared-memory tiled SGEMM whose A operand is gathered.  A block
// owns BM = 64 gathered rows -- the T rows of floor(64 / T) nodes, so every
// node's neighbors sit in one block -- and BN = 128 output columns.  It
// loads its own neighbor ids and weights, then walks Din in BK = 16 slabs:
// each thread fetches its share of the next slab of gathered rows and of
// Wq^T into registers while the block multiplies the current slab out of a
// double-buffered shared-memory tile, so one barrier per slab separates the
// two and the scattered row loads overlap the FMAs.  Each of the 256
// threads accumulates a 4 x 8 tile of q in f32 registers with plain FMA.
// The epilogue (+bq, leaky_relu slope 0.01, times w, sum over the node's T
// rows, guarded divide) runs in the same kernel through a shared-memory
// tile that reuses the slab buffers.  Blocks of one node tile are adjacent
// in launch order, so the H / 128 column tiles that re-read the same
// gathered rows find them in L2.  Rows past the batch are masked, not
// padded.  wgmma, TMA and cp.async pipelining are later work.

#include <cuda_runtime.h>

#include <cstdint>

#define BM 64
#define BN 128
#define BK 16
#define TM 4
#define TN 8
#define THREADS 256
#define AS_LD (BM + 4)                      // padded row of the A slab
#define SLAB_FLOATS (BK * AS_LD + BK * BN)  // one A slab + one B slab
#define QS_LD (BN + 1)
#define SMEM_FLOATS \
  (2 * SLAB_FLOATS > BM * QS_LD ? 2 * SLAB_FLOATS : BM * QS_LD)

// Per-thread share of one slab: A as one float4, B as two float4.  The
// wrapper guarantees Din % 4 == 0, H % 4 == 0 and 16-byte aligned h and
// Wq^T, so a float4 never straddles a row or reads out of bounds.
struct Slab {
  float a[4];
  float b[8];

  __device__ __forceinline__ void load(const float* __restrict__ h,
                                       const float* __restrict__ wqT,
                                       const int* rows_s, int k0, int n0,
                                       int din, int hdim, int tid) {
    const int r = tid / 4, k = (tid % 4) * 4;
    const int row = rows_s[r];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= 0 && k0 + k < din)
      v = *reinterpret_cast<const float4*>(h + (size_t)row * din + k0 + k);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int kb = idx / (BN / 4), n = (idx % (BN / 4)) * 4;
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + kb < din && n0 + n < hdim)
        u = *reinterpret_cast<const float4*>(
            wqT + (size_t)(k0 + kb) * hdim + n0 + n);
      b[4 * i] = u.x; b[4 * i + 1] = u.y; b[4 * i + 2] = u.z;
      b[4 * i + 3] = u.w;
    }
  }

  // Element (r, k) of A goes to As[k][r] and (k, n) of B to Bs[k][n];
  // thread tid holds A elements 4*tid .. 4*tid+3 in (r, k) order and B
  // elements 4*(tid + i*THREADS) + j.
  __device__ __forceinline__ void store(float* As, float* Bs, int tid) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid * 4 + i;
      As[(idx % BK) * AS_LD + idx / BK] = a[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = (tid + i * THREADS) * 4;
      *reinterpret_cast<float4*>(&Bs[(idx / BN) * BN + idx % BN]) =
          make_float4(b[4 * i], b[4 * i + 1], b[4 * i + 2], b[4 * i + 3]);
    }
  }
};

__global__ void __launch_bounds__(THREADS, 2)
agg_kernel(const float* __restrict__ h,     // [N, Din]
           const int* __restrict__ nb,      // [B, T]
           const float* __restrict__ w,     // [B, T]
           const float* __restrict__ wqT,   // [Din, H]
           const float* __restrict__ bq,    // [H]
           float* __restrict__ out,         // [B, H]
           int n_nodes, int T, int din, int hdim, int nodes_per_tile,
           int n_col_tiles) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  __shared__ int rows_s[BM];
  __shared__ float w_s[BM];
  __shared__ float denom_s[BM];

  const int tid = threadIdx.x;
  const int col_tile = blockIdx.x % n_col_tiles;
  const int node_tile = blockIdx.x / n_col_tiles;
  const int n0 = col_tile * BN;
  const int b0 = node_tile * nodes_per_tile;
  const int tile_nodes = min(nodes_per_tile, n_nodes - b0);
  const int tile_rows = tile_nodes * T;

  if (tid < BM) {
    if (tid < tile_rows) {
      const size_t g = (size_t)b0 * T + tid;
      rows_s[tid] = nb[g];
      w_s[tid] = w[g];
    } else {
      rows_s[tid] = -1;
      w_s[tid] = 0.f;
    }
  }
  __syncthreads();
  if (tid < tile_nodes) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += w_s[tid * T + t];
    denom_s[tid] = (s == 0.f) ? 1.f : s;
  }

  // thread (tx, ty) owns rows ty*4 .. ty*4+3 and columns tx*4 .. tx*4+3,
  // 64+tx*4 .. 64+tx*4+3 (neighbouring threads read neighbouring float4s)
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  Slab next;
  next.load(h, wqT, rows_s, 0, n0, din, hdim, tid);
  next.store(smem, smem + BK * AS_LD, tid);
  __syncthreads();
  const int n_slabs = (din + BK - 1) / BK;
  for (int s = 0; s < n_slabs; ++s) {
    const float* As = smem + (s & 1) * SLAB_FLOATS;
    const float* Bs = As + BK * AS_LD;
    if (s + 1 < n_slabs)
      next.load(h, wqT, rows_s, (s + 1) * BK, n0, din, hdim, tid);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As + k * AS_LD +
                                                         ty * TM);
      const float4 bl = *reinterpret_cast<const float4*>(Bs + k * BN +
                                                         tx * 4);
      const float4 bh = *reinterpret_cast<const float4*>(Bs + k * BN + 64 +
                                                         tx * 4);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (s + 1 < n_slabs) {
      float* nA = smem + ((s + 1) & 1) * SLAB_FLOATS;
      next.store(nA, nA + BK * AS_LD, tid);
    }
    __syncthreads();
  }

  // epilogue 1: weighted activations of every gathered row into Qs (the
  // slab buffers are free: the loop ended on a barrier)
  float* Qs = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const float wr = w_s[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
      const float bias = (n0 + c < hdim) ? bq[n0 + c] : 0.f;
      float q = acc[i][j] + bias;
      q = (q >= 0.f) ? q : 0.01f * q;
      Qs[r * QS_LD + c] = wr * q;
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

extern "C" int agg_launch(const void* h, const void* nb, const void* w,
                          const void* wqT, const void* bq, void* out,
                          int n_nodes, int T, int din, int hdim,
                          void* stream) {
  if (T < 1 || T > BM || din < 1 || din % 4 != 0 || hdim % 4 != 0 ||
      (uintptr_t)h % 16 != 0 || (uintptr_t)wqT % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int nodes_per_tile = BM / T;
  const int n_col_tiles = (hdim + BN - 1) / BN;
  const long long n_node_tiles =
      (n_nodes + nodes_per_tile - 1) / nodes_per_tile;
  const unsigned blocks = (unsigned)(n_node_tiles * n_col_tiles);
  agg_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)h, (const int*)nb, (const float*)w, (const float*)wqT,
      (const float*)bq, (float*)out, n_nodes, T, din, hdim, nodes_per_tile,
      n_col_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* agg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
