// K1: the restart-walk hop, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gcn_song_embeddings_tpu/ops/pallas_walk.py
// `_walk_kernel` (entry `pallas_walks_from_fused_tables`).  Same function:
// for every walker and every hop
//     col  = i2c_ext[s + slot(u0, d)]          (c2i start, deg) of a collection
//     row  = c2i_ext[col.s + slot(u1, col.d)]  (item, i2c start, i2c deg)
//     trace[h, w] = row.item
//     (s, d) = u2 < alpha ? origin extents : (row.s, row.d)
// with slot(u, d) = min(trunc(f32(u * f32(d))), max(d - 1, 0)).
//
// What bounds it on the H100: two DEPENDENT random 8-12 byte gathers per
// hop, so each walker is a chain of 2*H memory latencies; the bytes moved
// (uniforms in, trace out, records gathered) are far below the 3.35 TB/s
// rate.  Design: one thread per walker, its (start, deg) held in registers
// for all H hops, so a hop costs exactly the two gathers; the card hides
// latency by running many walkers (warps) at once.  The uniforms are read
// as [H, B, 3] and the trace written as [H, B], so a warp's reads and
// writes of one hop are contiguous (the caller transposes the trace).
// The TPU kernel's 8-int32 record packing in 4 KB windows and its padding
// of B to 1024 were Mosaic DMA constraints and are not carried over.
//
// Bit-identity with the plain version is the contract: the product is
// __fmul_rn (no fast-math contraction), the cast truncates toward zero,
// and the restart test compares in f32 as JAX does.

#include <cuda_runtime.h>

__device__ __forceinline__ int uniform_slot(float u, int deg) {
  int t = (int)__fmul_rn(u, (float)deg);  // truncation toward zero
  return min(t, max(deg - 1, 0));
}

__global__ void walk_kernel(const int* __restrict__ origin_ext,  // [n_items, 2]
                            const int* __restrict__ i2c_ext,     // [nnz_i2c, 2]
                            const int* __restrict__ c2i_ext,     // [nnz_c2i, 3]
                            const int* __restrict__ origins,     // [B]
                            const float* __restrict__ uniforms,  // [H, B, 3]
                            int* __restrict__ trace,             // [H, B]
                            int n_walkers, int n_hops, float alpha) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_walkers) return;
  const int o = origins[w];
  const int o_start = origin_ext[2 * o];
  const int o_deg = origin_ext[2 * o + 1];
  int start = o_start;
  int deg = o_deg;
  const size_t stride = (size_t)n_walkers;
  for (int h = 0; h < n_hops; ++h) {
    const float* u = uniforms + ((size_t)h * stride + w) * 3;
    const float u0 = u[0], u1 = u[1], u2 = u[2];
    const int e1 = start + uniform_slot(u0, deg);
    const int s2 = i2c_ext[2 * (size_t)e1];
    const int d2 = i2c_ext[2 * (size_t)e1 + 1];
    const int e2 = s2 + uniform_slot(u1, d2);
    const int item = c2i_ext[3 * (size_t)e2];
    const int next_start = c2i_ext[3 * (size_t)e2 + 1];
    const int next_deg = c2i_ext[3 * (size_t)e2 + 2];
    trace[(size_t)h * stride + w] = item;
    if (u2 < alpha) {
      start = o_start;
      deg = o_deg;
    } else {
      start = next_start;
      deg = next_deg;
    }
  }
}

extern "C" int walk_launch(const void* origin_ext, const void* i2c_ext,
                           const void* c2i_ext, const void* origins,
                           const void* uniforms, void* trace, int n_walkers,
                           int n_hops, float alpha, void* stream) {
  const int threads = 64;
  const int blocks = (n_walkers + threads - 1) / threads;
  walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)origin_ext, (const int*)i2c_ext, (const int*)c2i_ext,
      (const int*)origins, (const float*)uniforms, (int*)trace, n_walkers,
      n_hops, alpha);
  return (int)cudaGetLastError();
}

extern "C" const char* walk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
