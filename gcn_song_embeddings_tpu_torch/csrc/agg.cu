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
//
// The 16-bit forms (train.dtype "bfloat16" or "float16": the
// full-graph train step aggregates a 16-bit table in both layers) take
// the table and Wq in bf16 or f16 (`wq_tile16_kernel` lays Wq out, no
// split) and project with the 16-bit core of agg_tc.cuh
// (`project16_kernel`: the warp-specialized core, a producer warpgroup
// and two consumer warpgroups on alternate 64-row x 256-column tiles, a
// persistent grid of block pairs), one pass per product, exact in f32; P
// stays f32, as the JAX package's q is (a 16-bit P would move each
// value by up to 2^-9 relative).  Their bound at the 100k catalog, both
// layers (Din 512 and 128, H 512): 65 GFLOP at 989 TFLOP/s = 0.066 ms of
// products against the function's 554 MB (16-bit rows, ids and weights
// read once, the f32 output written once) = 0.165 ms at 3.35 TB/s, so
// bytes bound it.  This design adds P: 410 MB written and 4.1 GB
// gathered back (2.05 GB a layer, served by L2).  The projection's own
// bytes (rows read, P written, 538 MB) bound it at 0.16 ms; writing P
// from the accumulator fragment (32-byte pieces of 8 rows a store)
// cost more than its products, so each 64-column slab of a tile is
// staged in shared memory and written with coalesced 16-byte stores.
// The gather is the f32 one; `den_round` rounds the weight sum to bf16
// (1) or f16 (2) before the divide, as the JAX package's sum of a
// 16-bit weight array is (an f32 sum cast back).

#include <cuda_fp16.h>

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

// ---- the 16-bit projection ------------------------------------------------

// Row r of tile `tile`: table row m0 + r of the dense table, -1 past it
struct TableRows {
  int n_rows, n_col_tiles;
  __device__ __forceinline__ int operator()(int tile, int r) const {
    const int row = (tile / n_col_tiles) * BM16 + r;
    return row < n_rows ? row : -1;
  }
};

// P = leaky_relu(acc + bq), column-slab-major: each 64-column slab of a
// warpgroup's tile is one contiguous run of P, staged in its shared
// memory (rows EPI_LD16 floats apart) and stored with coalesced 16-byte
// stores; the tile's bq is prefetched while it multiplies
struct SlabEpilogue {
  const float* bq;
  float* P;
  unsigned char* smem;
  int n_rows, hdim, n_slabs, n_col_tiles;
  __device__ __forceinline__ void prefetch(int tile, int wg) const {
    prefetch_bq16(reinterpret_cast<float*>(smem + WG_OFF16 +
                                           wg * WG_BYTES16 + BQ16),
                  bq, (tile % n_col_tiles) * BN16, hdim);
    cp_async_commit();
  }
  __device__ __forceinline__ void operator()(int tile, float* acc,
                                             int wg) const {
    const int t = threadIdx.x % 128;
    unsigned char* mine = smem + WG_OFF16 + wg * WG_BYTES16;
    float* stage = reinterpret_cast<float*>(mine + EPI16);
    const float* bq_s = reinterpret_cast<const float*>(mine + BQ16);
    const int m0 = (tile / n_col_tiles) * BM16;
    const int n0 = (tile % n_col_tiles) * BN16;
    const int rows = min(BM16, n_rows - m0);
    cp_async_wait<0>();
    consumer_sync(wg);
#pragma unroll
    for (int q = 0; q < BN16 / SLAB; ++q) {
      const int slab = n0 / SLAB + q;
      if (slab >= n_slabs) break;                    // the same for all
#pragma unroll
      for (int ii = 0; ii < SLAB / 8; ++ii) {
        const int i = q * (SLAB / 8) + ii;
        const int cl = 8 * ii + 2 * (t % 4);       // column in the slab
        const float2 b = *reinterpret_cast<const float2*>(
            bq_s + frag_col(t, i));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float q0 = acc[4 * i + 2 * half] + b.x;
          float q1 = acc[4 * i + 2 * half + 1] + b.y;
          q0 = (q0 >= 0.f) ? q0 : 0.01f * q0;
          q1 = (q1 >= 0.f) ? q1 : 0.01f * q1;
          *reinterpret_cast<float2*>(stage + frag_row(t, half) * EPI_LD16 +
                                     cl) = make_float2(q0, q1);
        }
      }
      consumer_sync(wg);
      float* dst = P + ((size_t)slab * n_rows + m0) * SLAB;
      for (int f = t; f < rows * (SLAB / 4); f += 128) {
        const int r = f / (SLAB / 4), c4 = 4 * (f % (SLAB / 4));
        *reinterpret_cast<float4*>(dst + r * SLAB + c4) =
            *reinterpret_cast<const float4*>(stage + r * EPI_LD16 + c4);
      }
      consumer_sync(wg);
    }
  }
};

template <bool F16>
__global__ void __launch_bounds__(THREADS16, 1) __cluster_dims__(CLUSTER16, 1, 1)
project16_kernel(const uint16_t* __restrict__ h,     // [N, Din] bf16 / f16
                 const uint16_t* __restrict__ wq_t,  // Wq, tiled
                 const float* __restrict__ bq,       // [H]
                 float* __restrict__ P,              // [S][N][64]
                 int n_rows, int din, int hdim, int n_slabs, int n_col_tiles,
                 int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      aligned_ring(smem_raw));
  run_tiles16<F16>(smem, h, din, wq_t, (hdim + BN - 1) / BN, n_col_tiles,
                   n_tiles, TableRows{n_rows, n_col_tiles},
                   SlabEpilogue{bq, P, smem, n_rows, hdim, n_slabs,
                                n_col_tiles});
}

// x rounded to the nearest bf16 (ties to even), as f32 bits; finite x
__device__ __forceinline__ uint32_t bf16_round_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

// block = GATHER_NODES nodes x 16 lanes, each lane one float4 of a slab;
// den_round: the weight sum as it is (0), rounded to bf16 (1) or f16 (2)
__global__ void __launch_bounds__(GATHER_NODES * 16)
gather_mean_kernel(const float* __restrict__ P,   // [S][N][64]
                   const int* __restrict__ nb,    // [B, T]
                   const float* __restrict__ w,   // [B, T]
                   float* __restrict__ out,       // [B, H]
                   int n_nodes, int T, int n_rows, int hdim, int n_groups,
                   int den_round) {
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
  if (den_round == 1)
    den = __uint_as_float(bf16_round_bits(den));
  else if (den_round == 2)
    den = __half2float(__float2half_rn(den));
  if (den == 0.f) den = 1.f;
  if (c < hdim)
    *reinterpret_cast<float4*>(out + (size_t)node * hdim + c) =
        make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
}

// Not part of K2: a yardstick for the gather's reads.  `passes` streaming
// reads of `src` (n4 float4s, small enough that L2 holds them) through
// L2 only (ld.global.cg), each thread's sum written to `sink` so that no
// load is dropped; chip_smoke.py times it over as many bytes as the
// gather reads.
__global__ void __launch_bounds__(256)
l2_probe_kernel(const float4* __restrict__ src, int n4, int passes,
                float* __restrict__ sink) {
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  for (int p = 0; p < passes; ++p) {
#pragma unroll 4
    for (int i = i0; i < n4; i += stride) {
      const float4 v = __ldcg(src + i);
      s += (v.x + v.y) + (v.z + v.w);
    }
  }
  sink[i0] = s;
}

// Not part of K2 either: a yardstick for the full-graph step's row
// gathers (the port's counterpart of bench.py's `measure_gather_rates`,
// whose XLA gather + reduce never writes the rows back).  `reps` passes
// over the `n_idx` ids, pass r reading row (idx[j] + r) % n_rows of the
// table (rows of `row16` 16-byte pieces, f32, or bf16 where `bf16` != 0),
// one warp a row, each lane summing its pieces into a register; each
// thread's sum goes to `sink` so that no load is dropped.  Nothing is
// written but the sink, so the rate it gives is the gather's read rate.
__global__ void __launch_bounds__(256)
gather_probe_kernel(const uint4* __restrict__ table, int n_rows, int row16,
                    const int* __restrict__ idx, int n_idx, int reps,
                    int bf16, float* __restrict__ sink) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const int n_warps = gridDim.x * blockDim.x / 32;
  float s = 0.f;
  for (int r = 0; r < reps; ++r) {
    for (int j = tid / 32; j < n_idx; j += n_warps) {
      const long long row = ((long long)idx[j] + r) % n_rows;
      const uint4* src = table + row * row16;
      for (int c = lane; c < row16; c += 32) {
        const uint4 v = src[c];
        if (bf16) {
          s += (__uint_as_float(v.x << 16) + __uint_as_float(v.x & 0xffff0000u))
             + (__uint_as_float(v.y << 16) + __uint_as_float(v.y & 0xffff0000u))
             + (__uint_as_float(v.z << 16) + __uint_as_float(v.z & 0xffff0000u))
             + (__uint_as_float(v.w << 16) + __uint_as_float(v.w & 0xffff0000u));
        } else {
          s += (__uint_as_float(v.x) + __uint_as_float(v.y))
             + (__uint_as_float(v.z) + __uint_as_float(v.w));
        }
      }
    }
  }
  sink[tid] = s;
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

// Wq bf16 or f16 (the layout does not depend on which) -> its tiles
extern "C" int agg_tile16_launch(const void* wq, void* tiles, int hdim,
                                 int din, void* stream) {
  if (hdim < 1 || din < 1 || din % 8 != 0 || (uintptr_t)wq % 16 != 0 ||
      (uintptr_t)tiles % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int k_tiles = (din + BK16 - 1) / BK16;
  const long long n_chunks =
      (long long)((hdim + BN - 1) / BN) * k_tiles * BN * 8;
  const unsigned blocks = (unsigned)((n_chunks + 255) / 256);
  wq_tile16_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)wq, (uint16_t*)tiles, hdim, din, k_tiles, n_chunks);
  return (int)cudaGetLastError();
}

// f16 != 0: h and the tiles are f16, else bf16
extern "C" int agg_project16_launch(const void* h, const void* tiles,
                                    const void* bq, void* P, int n_rows,
                                    int din, int hdim, int f16,
                                    void* stream) {
  if (n_rows < 1 || din < 1 || hdim < 1 || din % 8 != 0 ||
      (uintptr_t)h % 16 != 0 || (uintptr_t)tiles % 16 != 0 ||
      (uintptr_t)P % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const void* kernel = f16 ? (const void*)project16_kernel<true>
                           : (const void*)project16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM16);
  if (err != cudaSuccess) return (int)err;
  const int n_col_tiles = (hdim + BN16 - 1) / BN16;
  const int n_slabs = (hdim + SLAB - 1) / SLAB;
  const long long n_row_tiles = (n_rows + BM16 - 1) / BM16;
  const long long n_tiles = n_row_tiles * n_col_tiles;
  unsigned blocks = 0;
  err = grid16(kernel,
               (n_row_tiles + CLUSTER16 - 1) / CLUSTER16 * n_col_tiles,
               &blocks);
  if (err != cudaSuccess) return (int)err;
  if (f16)
    project16_kernel<true><<<blocks, THREADS16, SMEM16, (cudaStream_t)stream>>>(
        (const uint16_t*)h, (const uint16_t*)tiles, (const float*)bq,
        (float*)P, n_rows, din, hdim, n_slabs, n_col_tiles, (int)n_tiles);
  else
    project16_kernel<false><<<blocks, THREADS16, SMEM16, (cudaStream_t)stream>>>(
        (const uint16_t*)h, (const uint16_t*)tiles, (const float*)bq,
        (float*)P, n_rows, din, hdim, n_slabs, n_col_tiles, (int)n_tiles);
  return (int)cudaGetLastError();
}

extern "C" int agg_gather_launch(const void* P, const void* nb, const void* w,
                                 void* out, int n_nodes, int T, int n_rows,
                                 int hdim, int den_round, void* stream) {
  if (T < 1 || hdim < 1 || hdim % 4 != 0 || den_round < 0 || den_round > 2 ||
      (uintptr_t)P % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_nodes < 1) return (int)cudaSuccess;
  const int n_slabs = (hdim + SLAB - 1) / SLAB;
  const int n_groups = (n_nodes + GATHER_NODES - 1) / GATHER_NODES;
  const unsigned blocks = (unsigned)((long long)n_slabs * n_groups);
  gather_mean_kernel<<<blocks, GATHER_NODES * 16, 0, (cudaStream_t)stream>>>(
      (const float*)P, (const int*)nb, (const float*)w, (float*)out, n_nodes,
      T, n_rows, hdim, n_groups, den_round);
  return (int)cudaGetLastError();
}

// sink: blocks x 256 floats
extern "C" int agg_l2_probe_launch(const void* src, int n4, int passes,
                                   void* sink, int blocks, void* stream) {
  if (n4 < 1 || passes < 1 || blocks < 1 || (uintptr_t)src % 16 != 0)
    return (int)cudaErrorInvalidValue;
  l2_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)src, n4, passes, (float*)sink);
  return (int)cudaGetLastError();
}

// sink: blocks x 256 floats
extern "C" int agg_gather_probe_launch(const void* table, int n_rows,
                                       int row16, const void* idx, int n_idx,
                                       int reps, int bf16, void* sink,
                                       int blocks, void* stream) {
  if (n_rows < 1 || row16 < 1 || n_idx < 1 || reps < 1 || blocks < 1 ||
      (uintptr_t)table % 16 != 0)
    return (int)cudaErrorInvalidValue;
  gather_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, n_rows, row16, (const int*)idx, n_idx, reps, bf16,
      (float*)sink);
  return (int)cudaGetLastError();
}

extern "C" const char* agg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
