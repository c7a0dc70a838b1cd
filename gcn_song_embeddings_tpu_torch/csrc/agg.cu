// K2: neighbor gather + Q-MLP + importance-weighted mean for Hopper
// (sm_90a), as "project every table row once, then gather".
//
// Replaces the Pallas TPU kernel gcn_song_embeddings_tpu/ops/pallas_agg.py
// `_agg_kernel` (entry `fused_gather_aggregate`).  Same function:
//     agg[b] = sum_t w[b,t] * leaky_relu(h[nb[b,t]] . Wq^T + bq)
//              / (sum_t w[b,t], or 1 where that sum is 0)
// for h [N, Din] f32, nb [B, T] int32, w [B, T] f32, Wq [H, Din], bq [H].
// leaky_relu acts on each projected row before the weighting, so
// projecting each table row once and gathering the projections is the
// same function.
//
// What bounds it on the H100: the tensor cores.  On the full-graph embed
// (B = N = 100k, T = 10) ids repeat about T times across nodes: the
// function needs each distinct row projected once, 2*U*Din*H operations
// for U distinct ids, and at f32 accuracy through 3xTF32 (csrc/agg_tc.cuh)
// that is 3 x 52 GFLOP at Din = H = 512 over 495 TFLOP/s = 0.32 ms.  The
// gathers then read B*T projected rows (2 GB per layer), which L2 serves.
//
// Design, three kernels per call:
//   1. `wq_split_kernel` (agg_tc.cuh): Wq -> TF32 big and small, in the
//      swizzled K-major tiles the tensor cores read.
//   2. `project_kernel`: the shared 3xTF32 core over the dense table (the
//      id list is arange(N)), epilogue P = leaky_relu(h Wq^T + bq) stored
//      column-slab-major, P [ceil(H/64)][N][64] f32, so one slab of the
//      100k catalog is 25.6 MB.
//   3. `gather_mean_kernel`: out[b] = sum_t w[b,t] * P[nb[b,t]] / denom[b]
//      with float4 loads, 16 lanes per node; the grid runs slab by slab,
//      so the blocks in flight read one slab, which the 50 MB L2 holds.
// K2 projects all N table rows whatever B is (where B*T < N some of that
// work is not needed).  No fallback: each launch is checked.

#include "agg_tc.cuh"

using namespace agg_tc;

constexpr int SLAB = 64;                      // P columns per slab
constexpr int PROJECT_SMEM = SMEM_ALIGN_SLACK + RING_BYTES + BM * 4;
constexpr int GATHER_NODES = 16;              // nodes per gather block

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
project_kernel(const float* __restrict__ h,      // [N, Din]
               const float* __restrict__ big_t,  // Wq big, tiled
               const float* __restrict__ small_t,
               const float* __restrict__ bq,     // [H]
               float* __restrict__ P,            // [S][N][64]
               int n_rows, int din, int hdim, int n_slabs, int n_col_tiles) {
  extern __shared__ unsigned char smem_raw[];
  float* ring = aligned_ring(smem_raw);
  int* rows_s = reinterpret_cast<int*>(ring + RING_BYTES / 4);

  const int tid = threadIdx.x;
  const int col_tile = blockIdx.x % n_col_tiles;
  const int m0 = (blockIdx.x / n_col_tiles) * BM;
  const int n0 = col_tile * BN;
  if (tid < BM) rows_s[tid] = m0 + tid < n_rows ? m0 + tid : -1;
  __syncthreads();

  float acc[64];
  tile_product(acc, ring, rows_s, h, din, big_t, small_t, col_tile);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + frag_row(tid, half);
    if (row >= n_rows) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = n0 + frag_col(tid, i);
      if (c >= n_slabs * SLAB) continue;
      float q0 = acc[4 * i + 2 * half] + (c < hdim ? bq[c] : 0.f);
      float q1 = acc[4 * i + 2 * half + 1] + (c + 1 < hdim ? bq[c + 1] : 0.f);
      q0 = (q0 >= 0.f) ? q0 : 0.01f * q0;
      q1 = (q1 >= 0.f) ? q1 : 0.01f * q1;
      *reinterpret_cast<float2*>(
          P + ((size_t)(c / SLAB) * n_rows + row) * SLAB + c % SLAB) =
          make_float2(q0, q1);
    }
  }
}

// block = GATHER_NODES nodes x 16 lanes, each lane one float4 of a slab
__global__ void __launch_bounds__(GATHER_NODES * 16)
gather_mean_kernel(const float* __restrict__ P,   // [S][N][64]
                   const int* __restrict__ nb,    // [B, T]
                   const float* __restrict__ w,   // [B, T]
                   float* __restrict__ out,       // [B, H]
                   int n_nodes, int T, int n_rows, int hdim, int n_groups) {
  const int slab = blockIdx.x / n_groups;
  const int node = (blockIdx.x % n_groups) * GATHER_NODES + threadIdx.x / 16;
  const int lane = threadIdx.x % 16;
  if (node >= n_nodes) return;
  const int c = slab * SLAB + 4 * lane;
  const float* ps = P + (size_t)slab * n_rows * SLAB + 4 * lane;
  const int* ids = nb + (size_t)node * T;
  const float* ws = w + (size_t)node * T;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  for (int t = 0; t < T; ++t) {
    const float wt = ws[t];
    const float4 v =
        *reinterpret_cast<const float4*>(ps + (size_t)ids[t] * SLAB);
    acc.x = fmaf(wt, v.x, acc.x);
    acc.y = fmaf(wt, v.y, acc.y);
    acc.z = fmaf(wt, v.z, acc.z);
    acc.w = fmaf(wt, v.w, acc.w);
    den += wt;
  }
  if (den == 0.f) den = 1.f;
  if (c < hdim)
    *reinterpret_cast<float4*>(out + (size_t)node * hdim + c) =
        make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
}

extern "C" int agg_split_launch(const void* wq, void* big_t, void* small_t,
                                int hdim, int din, void* stream) {
  if (hdim < 1 || din < 1 || din % 4 != 0 || (uintptr_t)wq % 16 != 0 ||
      (uintptr_t)big_t % 16 != 0 || (uintptr_t)small_t % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int k_tiles = (din + BK - 1) / BK;
  const long long n_chunks =
      (long long)((hdim + BN - 1) / BN) * k_tiles * BN * (BK / 4);
  const unsigned blocks = (unsigned)((n_chunks + 255) / 256);
  wq_split_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)wq, (float*)big_t, (float*)small_t, hdim, din, k_tiles,
      n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int agg_project_launch(const void* h, const void* big_t,
                                  const void* small_t, const void* bq,
                                  void* P, int n_rows, int din, int hdim,
                                  void* stream) {
  if (n_rows < 1 || din < 1 || hdim < 1 || din % 4 != 0 ||
      (uintptr_t)h % 16 != 0 || (uintptr_t)P % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PROJECT_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_col_tiles = (hdim + BN - 1) / BN;
  const int n_slabs = (hdim + SLAB - 1) / SLAB;
  const long long n_row_tiles = (n_rows + BM - 1) / BM;
  const unsigned blocks = (unsigned)(n_row_tiles * n_col_tiles);
  project_kernel<<<blocks, THREADS, PROJECT_SMEM, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)big_t, (const float*)small_t,
      (const float*)bq, (float*)P, n_rows, din, hdim, n_slabs, n_col_tiles);
  return (int)cudaGetLastError();
}

extern "C" int agg_gather_launch(const void* P, const void* nb, const void* w,
                                 void* out, int n_nodes, int T, int n_rows,
                                 int hdim, void* stream) {
  if (T < 1 || hdim < 1 || hdim % 4 != 0 || (uintptr_t)P % 16 != 0 ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_nodes < 1) return (int)cudaSuccess;
  const int n_slabs = (hdim + SLAB - 1) / SLAB;
  const int n_groups = (n_nodes + GATHER_NODES - 1) / GATHER_NODES;
  const unsigned blocks = (unsigned)((long long)n_slabs * n_groups);
  gather_mean_kernel<<<blocks, GATHER_NODES * 16, 0, (cudaStream_t)stream>>>(
      (const float*)P, (const int*)nb, (const float*)w, (float*)out, n_nodes,
      T, n_rows, hdim, n_groups);
  return (int)cudaGetLastError();
}

extern "C" const char* agg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
