// The tensor-core tile cores shared by K2 (csrc/agg.cu) and K3
// (csrc/dma_agg.cu), for Hopper (sm_90a): the 3xTF32 core for f32 tables
// and, at the end of this file, the 16-bit core for bf16 and f16 tables.
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


// ---- The 16-bit core (train.dtype "bfloat16" or "float16") ----------------
// One tile core for the bf16 and the f16 forms of K2's projection and K3,
// templated on the element type (F16 false: bf16).  A 16-bit x 16-bit
// product is exact in f32, so one wgmma pass per product replaces the
// three TF32 passes.  The block is warp-specialized, 384 threads:
//   - a producer warpgroup keeps the k chunks of the block's tiles in
//     flight in a STAGES16-deep ring on full/empty mbarriers.  It copies A
//     (a tile's BM16 = 64 gathered rows) into wgmma's 128-byte-swizzled
//     K-major layout by 16-byte cp.async, the chunk index XOR'd with
//     row % 8, each thread's copies arriving on the stage's full barrier
//     as they land (cp.async.mbarrier.arrive.noinc), and B (Wq, already in
//     `wq_tile16_kernel`'s tiles) by cp.async.bulk, completing as
//     transaction bytes on the same barrier;
//   - two consumer warpgroups take alternate tiles (ping-pong): each
//     multiplies a whole 64-row x BN16 = 256-column tile
//     (wgmma.m64n256k16, 128 f32 accumulators a thread) with both
//     operands read from shared memory (the SS form), keeping one chunk's
//     wgmma batch outstanding (wait_group 1), and then runs the tile's
//     epilogue while the other warpgroup's products of the next tile keep
//     the tensor cores busy.  An order barrier lets a warpgroup start its
//     products only once the other has issued all of its tile's, so the
//     two take turns on the tensor cores and never wait on a stage more
//     than one phase ahead;
//   - the block is one of a cluster of CLUSTER16 = 2 that multiply the
//     same Wq chunks at the same time, each copying half of a chunk into
//     both (cp.async.bulk .multicast::cluster), so Wq is read from L2 once
//     per 128 rows;
//   - each row's whole Din is summed in the tensor cores' f32
//     accumulator: no per-chunk promotion (a k chunk of 64 is 4 wgmma
//     steps; at Din 512 a row's sum takes 32 steps, against the 192 the
//     3xTF32 core had to break up; tests/test_torch_f16_gpu.py holds the
//     error against float64 to 4x the plain version's).
// Why this shape: ptxas gives every thread of a block the same register
// count, at most 65536 / threads (setmaxnreg does not raise it), and
// m64n256's 128 accumulators need ~154, so a block has at most three
// warpgroups (168 registers).  With two consumer warpgroups on one
// 128-row tile the tensor cores idled through every epilogue (on the
// H100, K3-bf16 stayed slower than its gather + einsum yardstick);
// ping-pong hides the epilogue under the other warpgroup's products.
// The kernels give `run_tiles16` the id of each row of a tile (< 0: a
// zero row) and an epilogue over the accumulator fragment of one
// warpgroup: its thread t (t = threadIdx.x % 128) holds tile rows
// `frag_row(t, half)` and, for i < 32, columns `frag_col(t, i)` (+1) in
// acc[4 i + 2 half] (and + 1).

constexpr int BN16 = 256;                      // output columns a tile
constexpr int BK16 = 64;                       // 16-bit elements a k chunk
constexpr int BM16 = 64;                       // rows a tile
constexpr int CONSUMERS16 = 256;               // two warpgroups
constexpr int PRODUCER_THREADS16 = 128;        // one warpgroup
constexpr int THREADS16 = CONSUMERS16 + PRODUCER_THREADS16;
constexpr int CLUSTER16 = 2;                   // blocks that share Wq
constexpr int WQ_TILE_BYTES16 = BN * 128;      // one 128-row tile of Wq
constexpr int A_STAGE16 = BM16 * 128;          // a k chunk of 64 rows
constexpr int STAGE16 = A_STAGE16 + BN16 * 128;  // + 256 Wq rows
constexpr int STAGES16 = 4;
constexpr int EPI_COLS16 = 64;                 // columns an epilogue pass
// floats between staged rows: a half-warp's fragment stores (rows
// lane / 4, 8 bytes apart along a row) hit 32 distinct banks
constexpr int EPI_LD16 = EPI_COLS16 + 8;
// shared memory: ring | per consumer warpgroup: epilogue staging
// [BM16][EPI_LD16] f32 (K3: 64 columns of w q; K2: a 64-column slab of
// P), bq of the tile's columns [BN16], K3's weights [BM16] and
// denominators [BM16] | the producer's row ids [BM16] | full barriers
// [STAGES16] | empty barriers [STAGES16] | order barriers [2]
constexpr int EPI16 = 0;                       // offsets in a warpgroup's
constexpr int BQ16 = EPI16 + BM16 * EPI_LD16 * 4;  // part
constexpr int W16 = BQ16 + BN16 * 4;
constexpr int DEN16 = W16 + BM16 * 4;
constexpr int WG_BYTES16 = DEN16 + BM16 * 4;
constexpr int WG_OFF16 = STAGES16 * STAGE16;   // + wg * WG_BYTES16
constexpr int ROWS_OFF16 = WG_OFF16 + 2 * WG_BYTES16;
constexpr int BAR_OFF16 = ROWS_OFF16 + BM16 * 4;
constexpr int SMEM16 = SMEM_ALIGN_SLACK + BAR_OFF16 + (2 * STAGES16 + 2) * 8;

static_assert(A_STAGE16 % 1024 == 0 && STAGE16 % 1024 == 0,
              "16-bit stages stay 1024-byte aligned (the swizzle atom)");
static_assert(BAR_OFF16 % 8 == 0 && WG_BYTES16 % 16 == 0,
              "mbarriers 8-byte, staging 16-byte aligned");
static_assert(SMEM16 <= 232448, "the 16-bit core fits one block an SM");
static_assert(BM16 * 8 % PRODUCER_THREADS16 == 0,
              "each producer thread copies whole A chunks");

// A consumer warpgroup's own barrier (named barriers 1 and 2), and the
// producer's (3); after setup the roles meet only on mbarriers
__device__ __forceinline__ void consumer_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 3, %0;" ::"n"(PRODUCER_THREADS16) : "memory");
}

// 4-byte global -> shared copy; src_bytes 0 writes 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) global -> shared by the copy engine,
// completing as transaction bytes on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` global -> shared at the same offset in every block of the
// cluster that `mask` names, completing as transaction bytes on the
// mbarrier at `bar`'s offset in each of them
__device__ __forceinline__ void bulk_copy_multicast(void* dst,
                                                    const void* src,
                                                    int bytes, uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// One arrival on the mbarrier at `bar`'s offset in block `rank` of the
// cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    int rank) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n\t}" ::"r"(
          smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// Every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ int cluster_special(int which) {
  int v;
  if (which == 0)
    asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  else if (which == 1)
    asm("mov.u32 %0, %%clusterid.x;" : "=r"(v));
  else
    asm("mov.u32 %0, %%nclusterid.x;" : "=r"(v));
  return v;
}

// bq of columns n0 .. n0 + BN16 (0 past H) into `bq_s` by cp.async, by a
// consumer warpgroup for its epilogue, which waits on the copies and
// meets first
__device__ __forceinline__ void prefetch_bq16(float* bq_s,
                                              const float* __restrict__ bq,
                                              int n0, int hdim) {
  for (int c = threadIdx.x % 128; c < BN16; c += 128) {
    const bool ok = n0 + c < hdim;
    cp_async4(bq_s + c, ok ? bq + n0 + c : bq, ok ? 4 : 0);
  }
}

// d[128] = A (smem, 64 x 16, K-major) x B (smem, 256 x 16, K-major)
// + (accumulate ? d : 0); both operands 128-byte swizzled
#define AGG_TC_WGMMA_N256(TYPE)                                              \
  asm volatile(                                                              \
      "{\n\t.reg .pred p;\n\t"                                               \
      "setp.ne.b32 p, %130, 0;\n\t"                                          \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TYPE "." TYPE " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "    \
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "    \
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "    \
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "    \
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "    \
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "     \
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "   \
      "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "   \
      "%126, %127}, "                                                        \
      "%128, %129, p, 1, 1, 0, 0;\n\t}"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),     \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),     \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),     \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),     \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),     \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),     \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),     \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),     \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),     \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),     \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),     \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),              \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),              \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),              \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),              \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),              \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),              \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])               \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)                            \
      : "memory")

template <bool F16>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t desc_a,
                                           uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_n256<false>(float* d, uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  int accumulate) {
  AGG_TC_WGMMA_N256("bf16");
}

template <>
__device__ __forceinline__ void wgmma_n256<true>(float* d, uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  AGG_TC_WGMMA_N256("f16");
}

#undef AGG_TC_WGMMA_N256

__device__ __forceinline__ void fence_acc128(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Wq [H, Din] 16-bit -> [ceil(H/BN)][ceil(Din/BK16)] tiles of BN rows x
// 128 bytes: the 16-byte chunk c (8 values) of row n sits at chunk
// c ^ (n % 8), zero where n >= H or the columns pass Din.  One thread per
// chunk.  A tile is one contiguous 16 KB block; the core's 256-wide
// column tile takes two of them.
__global__ void __launch_bounds__(256)
wq_tile16_kernel(const uint16_t* __restrict__ wq,
                 uint16_t* __restrict__ tiles, int hdim, int din,
                 int k_tiles, long long n_chunks) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_chunks) return;
  const int phys = (int)(q % 8);
  const long long rowq = q / 8;              // global tile row
  const int r = (int)(rowq % BN);
  const long long tile = rowq / BN;
  const int kt = (int)(tile % k_tiles), nt = (int)(tile / k_tiles);
  const int n = nt * BN + r, k = kt * BK16 + 8 * (phys ^ (r % 8));
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (n < hdim && k < din)
    v = *reinterpret_cast<const uint4*>(wq + (size_t)n * din + k);
  reinterpret_cast<uint4*>(tiles)[q] = v;
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// The 16-bit kernels run in clusters of CLUSTER16 = 2 blocks.  Cluster c
// walks the pair tiles c + j * (clusters) for j = 0, 1, ...: pair tile pt
// is row tiles 2 (pt / n_col_tiles) (block rank 0) and that + 1 (rank 1)
// at column tile pt % n_col_tiles, so the two blocks multiply the same
// Wq chunks at the same time.  A block's j-th tile goes to its consumer
// warpgroup j % 2.  Row tile rt, column tile ct is tile
// rt * n_col_tiles + ct: its rows are `row_id(tile, r)` of h (r < BM16,
// < 0: a zero row) and it reads Wq tiles 2 ct and 2 ct + 1 of `wq_t`, of
// which there are n_wq_tiles (a last column tile of at most 128 columns
// reads one, and the other 128 accumulator columns are not read).  A
// block whose pair has no second row tile runs its chunks on zero rows
// and skips the epilogue.  On a tile's first k chunk its warpgroup calls
// `epilogue.prefetch(tile, wg)` (cp.async of the epilogue's operands;
// one commit group), and after its last `epilogue(tile, acc, wg)` with
// every product of the tile done; the epilogue's threads are the
// warpgroup's 128, which meet by `consumer_sync(wg)`.  The kernel is
// launched with THREADS16 threads; `smem` is SMEM16 - SMEM_ALIGN_SLACK
// bytes, 1024-byte aligned; n_tiles = row tiles x n_col_tiles.
template <bool F16, class RowId, class Epilogue>
__device__ __forceinline__ void run_tiles16(
    unsigned char* smem, const uint16_t* __restrict__ h, int din,
    const uint16_t* __restrict__ wq_t, int n_wq_tiles, int n_col_tiles,
    int n_tiles, RowId row_id, Epilogue epilogue) {
  const int tid = threadIdx.x;
  const int k_tiles = (din + BK16 - 1) / BK16;
  const int rank = cluster_special(0), cid = cluster_special(1),
            n_clusters = cluster_special(2);
  const int n_row_tiles = n_tiles / n_col_tiles;
  const int n_pairs =
      (n_row_tiles + CLUSTER16 - 1) / CLUSTER16 * n_col_tiles;
  const int n_mine = (n_pairs - 1 - cid) / n_clusters + 1;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF16);
  uint64_t* empty = full + STAGES16;
  uint64_t* order = empty + STAGES16;          // [wg]: its turn to multiply
  auto pair_of = [&](int j) { return cid + j * n_clusters; };
  auto tile_of = [&](int j) {                  // -1: no row tile
    const int pt = pair_of(j);
    const int rt = CLUSTER16 * (pt / n_col_tiles) + rank;
    return rt < n_row_tiles ? rt * n_col_tiles + pt % n_col_tiles : -1;
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES16; ++s) {
      // every producer thread's copies, and thread 0's expected Wq bytes
      mbar_init(full + s, PRODUCER_THREADS16 + 1);
      // the warps of the consuming warpgroup in both blocks: a stage is
      // refilled in both
      mbar_init(empty + s, CLUSTER16 * 128 / 32);
    }
    mbar_init(order, 1);
    mbar_init(order + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  // the warpgroup's role, warp-uniform by construction (a branch on tid
  // alone leaves ptxas unsure and it then serializes every wgmma)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == CONSUMERS16 / 128) {
    // ---- producer: k chunk q of the block (its q / k_tiles-th tile,
    // chunk q % k_tiles) into stage q % STAGES16 once the consumers of
    // both blocks have freed it
    const int p = tid - CONSUMERS16;
    const int c = p % 8;                       // this thread's A chunk
    int* rows = reinterpret_cast<int*>(smem + ROWS_OFF16);
    // this thread's ids of the next tile, rows p + PRODUCER_THREADS16 i,
    // loaded a tile ahead
    constexpr int IDS = (BM16 + PRODUCER_THREADS16 - 1) / PRODUCER_THREADS16;
    int ids[IDS];
    auto load_ids = [&](int tile) {
#pragma unroll
      for (int i = 0; i < IDS; ++i) {
        const int r = p + i * PRODUCER_THREADS16;
        ids[i] = r < BM16 && tile >= 0 ? row_id(tile, r) : -1;
      }
    };
    load_ids(tile_of(0));
    for (int j = 0; j < n_mine; ++j) {
      producer_sync();                         // tile j - 1's ids are read
#pragma unroll
      for (int i = 0; i < IDS; ++i) {
        const int r = p + i * PRODUCER_THREADS16;
        if (r < BM16) rows[r] = ids[i];
      }
      producer_sync();
      if (j + 1 < n_mine) load_ids(tile_of(j + 1));
      const int ct = pair_of(j) % n_col_tiles;
      const int nb = min(2, n_wq_tiles - 2 * ct);
      for (int kc = 0; kc < k_tiles; ++kc) {
        const int q = j * k_tiles + kc, s = q % STAGES16;
        if (q >= STAGES16) mbar_wait(empty + s, ((q / STAGES16) + 1) & 1);
        unsigned char* st = smem + s * STAGE16;
        if (p == 0) {
          mbar_arrive_expect_tx(full + s, nb * WQ_TILE_BYTES16);
          for (int b = rank; b < nb; b += CLUSTER16)  // Wq tile 2 ct + b
            bulk_copy_multicast(
                st + A_STAGE16 + b * WQ_TILE_BYTES16,
                wq_t + ((size_t)(2 * ct + b) * k_tiles + kc) *
                           (WQ_TILE_BYTES16 / 2),
                WQ_TILE_BYTES16, full + s, (1 << CLUSTER16) - 1);
        }
        const int k = kc * BK16 + 8 * c;
#pragma unroll
        for (int i = 0; i < BM16 * 8 / PRODUCER_THREADS16; ++i) {
          const int r = p / 8 + i * (PRODUCER_THREADS16 / 8);
          const int id = rows[r];
          const bool ok = id >= 0 && k < din;
          cp_async16(st + r * 128 + ((c ^ (r & 7)) << 4),
                     ok ? h + (size_t)id * din + k : h, ok ? 16 : 0);
        }
        cp_async_arrive(full + s);
      }
    }
    cp_async_wait<0>();
  } else {
    // ---- consumer warpgroup wg = role: the block's tiles j = wg, wg + 2..
    const int wg = role;
    const bool leader = tid % 32 == 0;         // arrives for its warp
    auto release = [&](int s) {                // in both blocks
      if (leader)
        for (int r = 0; r < CLUSTER16; ++r) mbar_arrive_cluster(empty + s, r);
    };
    float acc[128];
    for (int j = wg; j < n_mine; j += 2) {
      // the other warpgroup has issued every product of tile j - 1
      if (j > 0) mbar_wait(order + wg, ((j - 1) / 2) & 1);
      const int tile = tile_of(j);
      for (int kc = 0; kc < k_tiles; ++kc) {
        const int q = j * k_tiles + kc, s = q % STAGES16;
        mbar_wait(full + s, (q / STAGES16) & 1);
        // the A copies landed through the generic proxy; wgmma reads
        // them through the async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const unsigned char* st = smem + s * STAGE16;
        const uint64_t da = b_desc(reinterpret_cast<const float*>(st)),
                       db = b_desc(reinterpret_cast<const float*>(
                           st + A_STAGE16));
        fence_acc128(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK16 / 16; ++ks)  // +32 bytes a k-step
          wgmma_n256<F16>(acc, da + 2 * ks, db + 2 * ks, kc > 0 || ks > 0);
        wgmma_commit();
        if (kc == k_tiles - 1 && tid % 128 == 0)
          mbar_arrive(order + (1 - wg));       // the other's turn
        if (kc == 0 && tile >= 0) epilogue.prefetch(tile, wg);
        if (kc < k_tiles - 1) {
          wgmma_wait_one();                    // chunk q - 1 is done
          fence_acc128(acc);
          if (kc > 0) release((q - 1) % STAGES16);
        } else {
          wgmma_wait_all();
          fence_acc128(acc);
          if (kc > 0) release((q - 1) % STAGES16);
          release(s);
          if (tile >= 0) epilogue(tile, acc, wg);
        }
      }
    }
  }
  // neither block leaves while the other may still copy into it or
  // arrive on its barriers
  cluster_sync();
}

// Persistent grid of the 16-bit core: as many clusters as fit the card at
// once (one block an SM), at most n_pairs; in *blocks
template <class Kernel>
cudaError_t grid16(Kernel kernel, long long n_pairs, unsigned* blocks) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER16 * 132);
  cfg.blockDim = dim3(THREADS16);
  cfg.dynamicSmemBytes = SMEM16;
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  *blocks = (unsigned)(CLUSTER16 * (n_pairs < clusters ? n_pairs : clusters));
  return cudaSuccess;
}

}  // namespace agg_tc
