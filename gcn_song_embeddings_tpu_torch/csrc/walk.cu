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
// What bounds it on the H100: memory latency.  Each hop is two DEPENDENT
// random 8-12 byte gathers; the bytes moved (uniforms in, trace out,
// records gathered) are far below the 3.35 TB/s rate, and the ~16 MB of
// edge records of a 100k-track graph sit in the 50 MB L2.  Walked as one
// chain per walker, a launch costs 2*H serial latencies and leaves most of
// the card idle at the sweep's B = 4096 (and all but one thread at a
// live-walk query's B = 1).
//
// Design: the restart decision `u[h, w, 2] < alpha` is an INPUT, so the
// hops split into independent restart segments before the launch: a
// segment starts at hop 0 or after a hop that restarts, and ends at the
// next hop that restarts (or at hop H-1).  At alpha = 0.85 a segment is
// ~1.18 hops long.  One thread per (hop h, walker w) over the [H, B] grid;
// the thread whose hop starts a segment (h == 0 or u[h-1, w, 2] < alpha,
// the very f32 compare that ends the segment before it) walks it from the
// origin's extents, every other thread returns, so each trace entry is
// written by exactly one thread and a launch costs about the longest
// segment's latency chain instead of 2*H.  Inside a segment, hop k+1's
// uniforms are loaded before hop k's gathers, so a long segment (alpha =
// 0: the whole walk) costs the two gathers per hop and not the uniforms'
// load as well.  That load is unconditional (at the last hop it rereads
// this hop's row): predicated on the segment going on, ptxas placed it
// only after the first gather returned and sank the record's next-hop
// fields below the trace store, and alpha = 0 was no faster than one
// chain per walker.  Unconditional, it also loads a row that the 85 % of
// segments ending after one hop at alpha = 0.85 never use.  Blocks of 64
// threads spread the B walkers of hop 0 (at alpha = 0 the only ones) over
// B / 64 SMs.  A warp covers 32 consecutive (h, w) of the flat grid, so its reads of
// the uniforms [H, B, 3] and its writes of the trace [H, B] are
// contiguous (the caller transposes the trace).
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

__global__ void __launch_bounds__(64)
    walk_kernel(const int2* __restrict__ origin_ext,  // [n_items, 2]
                const int2* __restrict__ i2c_ext,     // [nnz_i2c, 2]
                const int* __restrict__ c2i_ext,      // [nnz_c2i, 3]
                const int* __restrict__ origins,      // [B]
                const float* __restrict__ uniforms,   // [H, B, 3]
                int* __restrict__ trace,              // [H, B]
                int n_walkers, int n_hops, float alpha) {
  const size_t stride = (size_t)n_walkers;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)n_hops * stride) return;
  int h = (int)(t / stride);
  const int w = (int)(t - (size_t)h * stride);
  // every load the first hop needs starts before the decision
  const float* u = uniforms + 3 * t;
  float u0 = u[0], u1 = u[1], u2 = u[2];
  const int2 org = origin_ext[origins[w]];
  if (h > 0 && !((u - 3 * stride)[2] < alpha)) return;
  int start = org.x;
  int deg = org.y;
  int* out = trace + t;
  for (;;) {
    const int e1 = start + uniform_slot(u0, deg);
    const bool more = !(u2 < alpha) && h + 1 < n_hops;
    const float* next = h + 1 < n_hops ? u + 3 * stride : u;
    const float n0 = next[0], n1 = next[1], n2 = next[2];
    const int2 col = i2c_ext[e1];
    const int* row = c2i_ext + 3 * (size_t)(col.x + uniform_slot(u1, col.y));
    const int item = row[0], next_start = row[1], next_deg = row[2];
    *out = item;
    if (!more) return;
    start = next_start;
    deg = next_deg;
    u = next;
    u0 = n0;
    u1 = n1;
    u2 = n2;
    out += stride;
    ++h;
  }
}

extern "C" int walk_launch(const void* origin_ext, const void* i2c_ext,
                           const void* c2i_ext, const void* origins,
                           const void* uniforms, void* trace, int n_walkers,
                           int n_hops, float alpha, void* stream) {
  const int threads = 64;
  const size_t n = (size_t)n_walkers * n_hops;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int2*)origin_ext, (const int2*)i2c_ext, (const int*)c2i_ext,
      (const int*)origins, (const float*)uniforms, (int*)trace, n_walkers,
      n_hops, alpha);
  return (int)cudaGetLastError();
}

extern "C" const char* walk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
