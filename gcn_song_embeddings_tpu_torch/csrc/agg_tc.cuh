// The 3xTF32 tensor-core tile core shared by K2 (csrc/agg.cu) and K3
// (csrc/dma_agg.cu), for Hopper (sm_90a).
//
// Both kernels need q = leaky_relu(h[id] . Wq^T + bq) for a block of
// gathered rows of h.  A single TF32 product keeps 11 significant bits of
// each operand (max |err| ~2.8e-3 at Din = H = 512 against float64), and
// the port is held to f32 (1e-4 against the plain version, 2e-5 against
// the JAX package on the CPU).  3xTF32 splits each operand into a TF32
// "big" part and a TF32 "small" part, x = big + small, and sums
// a_small*b_big + a_big*b_small + a_big*b_big in f32 (small*small is
// dropped): as accurate as f32, on the tensor cores (495 TFLOP/s of TF32
// against 67 TFLOP/s of f32 FMA outside them).
//
// Layout of the product, per block: BM = 192 rows x BN = 128 output
// columns, Din walked in chunks of BK = 32 floats (128 bytes).
//   - A (rows of h picked by an id list; K3 the gathered neighbours, K2's
//     projection the dense table) is staged with 16-byte `cp.async` into
//     a STAGES-deep shared-memory ring, rows BK + 4 floats apart so that
//     the fragment reads of a warp hit 32 distinct banks.  Rows past the
//     block's count and columns past Din are zero-filled by the copy.
//     Each thread then loads its wgmma A fragments from shared memory and
//     splits them into big and small in registers (cvt.rna.tf32.f32).
//   - B is Wq as stored, [H, Din], which is K-major.  `wq_split_kernel`
//     splits it once per call into big and small and writes each in
//     wgmma's 128-byte-swizzled K-major tile layout, [H/BN][Din/BK] tiles
//     of BN rows x 128 bytes, zero-padded; a tile is one contiguous 16 KB
//     block, so the ring stages it with plain 16-byte copies, already
//     swizzled, and no tensor map is needed.
//   - Three warpgroups (384 threads, 64 rows each) each run
//     wgmma.m64n128k8.f32.tf32.tf32 with A from registers (the RS form)
//     and B from the ring: per k-step of 8, the two small-term products
//     first, then big x big, into 64 f32 registers per thread that hold
//     one k chunk's sum; two k-steps' fragments per wgmma batch.  The
//     tensor cores round their f32 sums less carefully than an FMA: with
//     all 192 products of a row (Din 512) chained in one accumulator the
//     error against float64 was several times the plain f32 version's
//     (tests/test_torch_kernels_gpu.py holds it to 4x, which that form
//     failed), so each chunk's sum is added to a second set of 64
//     accumulators by the CUDA cores, as DeepGEMM promotes its FP8 sums.
//     With 128 accumulators a thread needs ~166 registers, so one block
//     fits an SM, with a 3-stage ring (178 KB).  Three warpgroups rather
//     than two re-read Wq's tiles once per 192 rows instead of 128.
// The epilogue is the caller's: the accumulator fragment of thread t
// holds rows 64*wg + 16*warp + lane/4 (+8) and, for i < 16, columns
// 8*i + 2*(lane%4) (+1) of the block's tile (`frag_row`, `frag_col`).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace agg_tc {

constexpr int WARPGROUPS = 3;
constexpr int THREADS = 128 * WARPGROUPS;
constexpr int BM = 64 * WARPGROUPS;
constexpr int MIN_BLOCKS = 1;  // __launch_bounds__' blocks per SM
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int KGROUP = 2;  // k-steps of 8 per wgmma batch
constexpr int A_LD = BK + 4;                   // floats between A rows
constexpr int B_TILE_FLOATS = BN * BK;         // 16 KB, 1024-byte aligned
constexpr int STAGE_FLOATS = 2 * B_TILE_FLOATS + BM * A_LD;
constexpr int RING_BYTES = STAGES * STAGE_FLOATS * 4;
constexpr uint32_t TF32_MASK = 0xFFFFE000u;  // TF32: 10 mantissa bits

static_assert((STAGE_FLOATS * 4) % 1024 == 0, "B tiles stay 1024-byte aligned");
static_assert((A_LD * 4) % 16 == 0, "A rows stay 16-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TF32 rounding to nearest, ties away from zero, low 13 bits cleared
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & TF32_MASK;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// K-major operand in 128-byte-swizzled 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint32_t addr = smem_addr(tile);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d[64] = A (4 TF32 registers of the m64k8 fragment) x B (smem, 128 x 8)
// + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate)
      : "memory");
}

// Keeps the compiler from moving accumulator accesses across a wgmma
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ int frag_row(int tid, int half) {
  const int lane = tid % 32;
  return (tid / 128) * 64 + ((tid % 128) / 32) * 16 + lane / 4 + 8 * half;
}

__device__ __forceinline__ int frag_col(int tid, int i) {
  return 8 * i + 2 * (tid % 4);
}

// Wq [H, Din] -> big and small, each in [ceil(H/BN)][ceil(Din/BK)] tiles
// of BN rows x BK floats: element (n, k) of a tile sits in row n, 16-byte
// chunk (k / 4) ^ (n % 8), zero where n >= H or k >= Din.  One thread
// per 16-byte chunk.
__global__ void __launch_bounds__(256)
wq_split_kernel(const float* __restrict__ wq, float* __restrict__ big,
                float* __restrict__ small, int hdim, int din, int k_tiles,
                long long n_chunks) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_chunks) return;
  const int phys = (int)(q % (BK / 4));
  const long long rowq = q / (BK / 4);       // global tile row
  const int r = (int)(rowq % BN);
  const long long tile = rowq / BN;
  const int kt = (int)(tile % k_tiles), nt = (int)(tile / k_tiles);
  const int n = nt * BN + r, k = kt * BK + 4 * (phys ^ (r % 8));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n < hdim && k < din)
    v = *reinterpret_cast<const float4*>(wq + (size_t)n * din + k);
  const float x[4] = {v.x, v.y, v.z, v.w};
  uint32_t hb[4], hs[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) split(x[j], hb[j], hs[j]);
  reinterpret_cast<uint4*>(big)[q] = make_uint4(hb[0], hb[1], hb[2], hb[3]);
  reinterpret_cast<uint4*>(small)[q] = make_uint4(hs[0], hs[1], hs[2], hs[3]);
}

// The block's product: acc (this thread's fragment, zeroed here) =
// A . Wq^T over column tile n_tile, A row r = h[rows_s[r]] (rows_s[r] < 0:
// a zero row).  `ring` is RING_BYTES of 1024-byte aligned shared memory;
// rows_s must be visible to every thread (a barrier after it was
// written).  Ends with every copy and product done and a barrier, so the
// caller may reuse the ring.
__device__ __forceinline__ void tile_product(
    float* acc, float* ring, const int* rows_s, const float* __restrict__ h,
    int din, const float* __restrict__ big_t,
    const float* __restrict__ small_t, int n_tile) {
  const int tid = threadIdx.x;
  const int k_tiles = (din + BK - 1) / BK;
  const float* big_base = big_t + (size_t)n_tile * k_tiles * B_TILE_FLOATS;
  const float* small_base =
      small_t + (size_t)n_tile * k_tiles * B_TILE_FLOATS;
  const int c4 = (tid % 8) * 4;              // this thread's A column

  auto load_stage = [&](int kt) {
    float* st = ring + (kt % STAGES) * STAGE_FLOATS;
    const float* bb = big_base + (size_t)kt * B_TILE_FLOATS;
    const float* bs = small_base + (size_t)kt * B_TILE_FLOATS;
#pragma unroll
    for (int f = tid * 4; f < B_TILE_FLOATS; f += THREADS * 4) {
      cp_async16(st + f, bb + f, 16);
      cp_async16(st + B_TILE_FLOATS + f, bs + f, 16);
    }
    float* as = st + 2 * B_TILE_FLOATS;
    const int k = kt * BK + c4;
#pragma unroll
    for (int j = 0; j < BM * BK / (4 * THREADS); ++j) {
      const int r = tid / 8 + j * (THREADS / 8);
      const int id = rows_s[r];
      const bool ok = id >= 0 && k < din;
      cp_async16(as + r * A_LD + c4, ok ? h + (size_t)id * din + k : h,
                 ok ? 16 : 0);
    }
  };

  float part[64];  // one k chunk's products, summed into acc in f32
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s);
    cp_async_commit();
  }
  const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = (tid / 128) * 64 + ((tid % 128) / 32) * 16 + g;
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    // this thread's copies are done; publish them to the async proxy
    // (wgmma reads B through it), then meet: every copy of stage kt has
    // landed and every warpgroup is done with stage kt - 1
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (kt + STAGES - 1 < k_tiles) load_stage(kt + STAGES - 1);
    cp_async_commit();

    const float* st = ring + (kt % STAGES) * STAGE_FLOATS;
    const float* as = st + 2 * B_TILE_FLOATS;
    const uint64_t db = b_desc(st), ds = b_desc(st + B_TILE_FLOATS);
    fence_acc(part);
#pragma unroll
    for (int k0 = 0; k0 < BK / 8; k0 += KGROUP) {
      uint32_t ab[KGROUP][4], asm_[KGROUP][4];
#pragma unroll
      for (int j = 0; j < KGROUP; ++j) {
        const float* a0 = as + r0 * A_LD + (k0 + j) * 8 + t4;
        split(a0[0], ab[j][0], asm_[j][0]);
        split(a0[8 * A_LD], ab[j][1], asm_[j][1]);
        split(a0[4], ab[j][2], asm_[j][2]);
        split(a0[8 * A_LD + 4], ab[j][3], asm_[j][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KGROUP; ++j) {
        // +32 bytes per k-step inside the swizzled 128-byte rows
        const int ks = k0 + j;
        wgmma_tf32(part, asm_[j], db + 2 * ks, ks > 0);
        wgmma_tf32(part, ab[j], ds + 2 * ks, 1);
        wgmma_tf32(part, ab[j], db + 2 * ks, 1);
      }
      wgmma_commit();
      wgmma_wait_all();  // the A registers are free again
    }
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Dynamic shared memory rounded up to 1024 bytes (the swizzle atom)
__device__ __forceinline__ float* aligned_ring(unsigned char* smem) {
  const uint32_t a = smem_addr(smem);
  return reinterpret_cast<float*>(smem + ((1024 - (a & 1023)) & 1023));
}

constexpr int SMEM_ALIGN_SLACK = 1024;

}  // namespace agg_tc
