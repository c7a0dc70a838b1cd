// K4: the stochastic int8 row quantizer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gcn_song_embeddings_tpu/ops/quantize.py
// `_quant_kernel` (entry `quantize_rows_pallas`).  Same function: for each
// row x of emb [N, d] f32
//     s    = absmax(x) * f32(1/127), or 1 for an all-zero row
//     y    = x / s                          (IEEE divide)
//     q    = floor(y) + (u < y - floor(y)),  u = (bits >> 8) * 2^-24
//     vals = clip(q, -127, 127) as int8,    scales = s
// so each value rounds up with probability equal to its fraction: the
// rounding is unbiased.
//
// The random bits.  The TPU kernel draws them from the TPU's generator,
// seeded per row tile, which no other device reproduces.  Here they are a
// counter-based hash, a pure function of (seed, row, column):
//     key  = fmix32(seed ^ 0x9E3779B9)          (computed by the wrapper)
//     bits = fmix32(fmix32(row ^ key) ^ column)
// with fmix32 murmur3's 32-bit finalizer (two multiplies, three
// xor-shifts).  Since the bits do not depend on how rows are tiled over
// blocks, the plain PyTorch version (ops/quant_kernel.py) computes the very
// same bits, and kernel and plain version agree bit for bit.
//
// What bounds it on the H100: bytes.  Each element is read once (4 bytes)
// and written once (1 byte), with a few dozen integer and float operations
// in between: at 100k x 128, 51.2 MB read and 13.2 MB written, 0.019 ms at
// 3.35 TB/s.  Design: one warp per row, each lane reading float4s (a
// 128-wide row is one 512-byte coalesced read per warp), a warp-shuffle
// max for absmax, then a second pass over the row (an L1/L2 hit) that
// rounds and stores packed char4s.  The value is clipped to +-127 while
// still a float: y can round to just above 127, so floor(y) + 1 can be 128,
// and converting 128 to int8 is undefined.  The TPU kernel's padding of N
// to its 256-row tile is not carried over: rows past N are simply not run.
// The wrapper requires d % 4 == 0 and a 16-byte aligned input.

#include <cuda_runtime.h>

#include <cstdint>

#define THREADS 256  // 8 warps: 8 rows per block

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ signed char round_one(float x, float scale,
                                                 uint32_t row_hash,
                                                 uint32_t col) {
  const float y = __fdiv_rn(x, scale);
  const float low = floorf(y);
  const uint32_t bits = fmix32(row_hash ^ col);
  const float u = __fmul_rn((float)(bits >> 8), 5.9604644775390625e-8f);
  float q = __fadd_rn(low, u < __fsub_rn(y, low) ? 1.0f : 0.0f);
  q = fminf(fmaxf(q, -127.0f), 127.0f);  // clip before the int8 cast
  return (signed char)__float2int_rn(q);
}

__global__ void __launch_bounds__(THREADS)
    quant_kernel(const float* __restrict__ emb,  // [n, d]
                 signed char* __restrict__ values,  // [n, d]
                 float* __restrict__ scales,        // [n]
                 int n, int d, uint32_t key) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // a whole warp leaves together
  const int d4 = d >> 2;
  const float4* x = reinterpret_cast<const float4*>(emb + (size_t)row * d);
  float m = 0.0f;
  for (int i = lane; i < d4; i += 32) {
    const float4 v = x[i];
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                       fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
  const float scale = m == 0.0f ? 1.0f : __fmul_rn(m, 1.0f / 127.0f);
  const uint32_t row_hash = fmix32((uint32_t)row ^ key);
  char4* out = reinterpret_cast<char4*>(values + (size_t)row * d);
  for (int i = lane; i < d4; i += 32) {
    const float4 v = x[i];
    const uint32_t c = 4u * (uint32_t)i;
    char4 q;
    q.x = round_one(v.x, scale, row_hash, c);
    q.y = round_one(v.y, scale, row_hash, c + 1);
    q.z = round_one(v.z, scale, row_hash, c + 2);
    q.w = round_one(v.w, scale, row_hash, c + 3);
    out[i] = q;
  }
  if (lane == 0) scales[row] = scale;
}

extern "C" int quant_launch(const void* emb, void* values, void* scales,
                            int n, int d, unsigned int key, void* stream) {
  const int rows_per_block = THREADS / 32;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  quant_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)emb, (signed char*)values, (float*)scales, n, d,
      (uint32_t)key);
  return (int)cudaGetLastError();
}

extern "C" const char* quant_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
