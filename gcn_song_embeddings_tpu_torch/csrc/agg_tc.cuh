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

#include <cuda_bf16.h>
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



// ---- The 16-bit core (bf16 and f16 tables; f32 tables in bf16 passes) ---
// One tile core for K2's projection and K3 on bf16 and f16 tables
// (train.dtype "bfloat16" / "float16"; F16 false: bf16), and on f32 tables
// under the precision policy (GCN_TPU_MATMUL_PRECISION, the JAX package's
// TPU numerics), rounded to bf16 (one pass) or split into bf16 hi and lo
// = bf16(x - hi) (three: hi*lo + lo*hi + hi*hi a k-step), to nearest even
// (XLA's convert), as they are staged.  A 16-bit x 16-bit product is exact
// in f32, so one wgmma pass per product replaces the three TF32 passes.
// A block (384 threads, one an SM) is one of a cluster of CLUSTER16 = 2:
//   - the pair takes a pair of 64-row tiles (BM16 rows of h picked by an
//     id list) and sweeps a run of Wq's 128-column tiles over them, so
//     each row is read (and rounded) once a run, not once a column tile.
//     Where a row tile's k chunks fit the A slots (A_SLOTS16 of 64 rows x
//     64 16-bit values in wgmma's 128-byte-swizzled K-major layout, two a
//     chunk for three passes: Din <= 896, three passes 448) they stay
//     resident through the run; deeper rows are staged again for every
//     tile ("streamed");
//   - three stager warps fill the next free A slot: 16-bit rows by
//     16-byte cp.async, arriving on the slot's full barrier as they land;
//     f32 rows by 16-byte loads into registers, one chunk's loads in
//     flight while the chunk before is rounded and stored;
//   - one lane of the producer warpgroup's first warp streams Wq's chunks
//     (`wq_tile16_kernel`'s or `wq_tile_bf16x_kernel`'s tiles) in
//     R_W_TILES stages of 16 KB (hi and lo: half as many of 32 KB), each
//     block copying half of a chunk into both
//     (cp.async.bulk .multicast::cluster), so Wq is read from L2 once per
//     128 rows;
//   - two consumer warpgroups take alternate tiles, each multiplying a
//     whole 64-row x 128-column tile (wgmma.m64n128k16, both operands from
//     shared memory) and then running the tile's epilogue, whose operands
//     were prefetched a tile ahead, while the other warpgroup multiplies.
// The sum of each output's Din products is promoted: the tensor cores'
// f32 accumulator truncates as it adds (against float64, one accumulator
// over a whole row erred 5.3x the plain f32 version at Din 1,024, with a
// negative bias), so a tile's products run into a partial sum `part` for
// an interval of PROMOTE_STEPS16 k-steps of 16 products (three passes:
// PROMOTE_STEPS16_X3 k-steps of three products each), and the CUDA cores
// add each partial to the f32 sum `acc`, rounded to nearest, interval
// after interval in k order, as the 3xTF32 core above and DeepGEMM do.
// Why m64n128: a 384-thread block has 168 registers a thread, which hold
// m64n128's 64 accumulators and 64 partials (the 3xTF32 core's budget),
// while m64n256's 128 and 128 would not fit even the 232 that setmaxnreg
// could give a consumer.  A
// promotion waits for its interval's products, so a warpgroup hands the
// tensor cores to the other (the order barrier) as early as the stages'
// phases allow, not once all of its tile's products are issued: the other
// warpgroup's products fill those waits.
// The kernels give the core the id of each row of a tile (< 0: a zero
// row) and an epilogue over the accumulator fragment of one warpgroup:
// its thread t (t = threadIdx.x % 128) holds tile rows `frag_row(t,
// half)` and, for i < 16, columns `frag_col(t, i)` (+1) in acc[4 i + 2
// half] (and + 1).

constexpr int BN16 = BN;                       // output columns a tile
constexpr int BK16 = 64;                       // 16-bit elements a k chunk
constexpr int BM16 = 64;                       // rows a tile
constexpr int CONSUMERS16 = 256;               // two warpgroups
constexpr int THREADS16 = CONSUMERS16 + 128;   // + the producer warpgroup
constexpr int CLUSTER16 = 2;                   // blocks that share Wq
constexpr int WQ_TILE_BYTES16 = BN16 * 128;    // a k chunk of a Wq tile
constexpr int A_STAGE16 = BM16 * 128;          // a k chunk of 64 rows
// what A's rows are in device memory: the table's own 16-bit rows, or f32
// rows rounded to bf16 (one pass) or split into bf16 hi and lo (three
// passes) as they are staged
constexpr int TABLE16 = 0, F32_X1 = 1, F32_X3 = 3;
// k-steps of 16 products that a tile's partial sum runs in the tensor
// cores before the CUDA cores add it to the f32 sum (a k chunk is
// CHUNK_STEPS16): one pass and the 16-bit tables PROMOTE_STEPS16, three
// passes PROMOTE_STEPS16_X3 (k-steps of three products; their bias asks
// for the shorter interval), the longest intervals that hold the float64
// bars (PERF.md, scripts/bf16x_error_probe.py: intervals of two and four
// k chunks, one chunk's products kept in flight, missed the bias bar and
// gained under 3 %).
constexpr int CHUNK_STEPS16 = BK16 / 16;
constexpr int PROMOTE_STEPS16 = 4;
constexpr int PROMOTE_STEPS16_X3 = 2;
// 0 builds the core without its epilogue, so its kernels write nothing:
// what its tiles cost alone (scripts/bf16x_ab.py --no-epilogue)
#ifndef AGG_TC_EPILOGUE
#define AGG_TC_EPILOGUE 1
#endif
constexpr int EPI_COLS16 = 64;                 // columns an epilogue pass
// floats between staged rows: a half-warp's fragment stores (rows
// lane / 4, 8 bytes apart along a row) hit 32 distinct banks
constexpr int EPI_LD16 = EPI_COLS16 + 8;
// a consumer warpgroup's shared memory: epilogue staging [BM16][EPI_LD16]
// f32 (K3: 64 columns of w q; K2: a 64-column slab of P), bq of the
// tile's columns [BN16], K3's weights [BM16] and denominators [BM16]
constexpr int EPI16 = 0;                       // offsets in a warpgroup's
constexpr int BQ16 = EPI16 + BM16 * EPI_LD16 * 4;  // part
constexpr int W16 = BQ16 + BN16 * 4;
constexpr int DEN16 = W16 + BM16 * 4;
constexpr int WG_BYTES16 = DEN16 + BM16 * 4;

static_assert(CHUNK_STEPS16 % PROMOTE_STEPS16 == 0 &&
                  CHUNK_STEPS16 % PROMOTE_STEPS16_X3 == 0,
              "a promotion interval divides a k chunk");
static_assert(A_STAGE16 % 1024 == 0 && WQ_TILE_BYTES16 % 1024 == 0,
              "16-bit stages stay 1024-byte aligned (the swizzle atom)");
static_assert(WG_BYTES16 % 16 == 0, "epilogue staging 16-byte aligned");

// A consumer warpgroup's own barrier (named barriers 1 and 2); after
// setup the roles meet only on mbarriers
__device__ __forceinline__ void consumer_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
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


// Wq [H, Din] 16-bit -> [ceil(H/BN)][ceil(Din/BK16)] tiles of BN rows x
// 128 bytes: the 16-byte chunk c (8 values) of row n sits at chunk
// c ^ (n % 8), zero where n >= H or the columns pass Din.  One thread per
// chunk.  A tile is one contiguous 16 KB block: a k chunk of the core's
// column tile.
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

// x -> its bf16 bits, rounded to nearest even
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// 8 f32 values -> their bf16 roundings packed in a 16-byte chunk (element
// j in the low half of word j / 2 when j is even), and, where `lo` is
// wanted, the roundings of what each leaves over
template <bool LO>
__device__ __forceinline__ void bf16_chunk(const float4& a, const float4& b,
                                           uint4& hi, uint4& lo) {
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t h0 = bf16_bits(x[2 * j]), h1 = bf16_bits(x[2 * j + 1]);
    h[j] = h0 | (h1 << 16);
    if (LO)
      l[j] = bf16_bits(x[2 * j] - __uint_as_float(h0 << 16)) |
             (bf16_bits(x[2 * j + 1] - __uint_as_float(h1 << 16)) << 16);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  if (LO) lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// Wq [H, Din] f32 (Din % 8 == 0) -> `wq_tile16_kernel`'s bf16 tiles of
// its rounding `hi` and, where `lo` is not null, of what that leaves over
// (the three-pass split).  One thread per chunk of 8 elements.
__global__ void __launch_bounds__(256)
wq_tile_bf16x_kernel(const float* __restrict__ wq, uint16_t* __restrict__ hi,
                     uint16_t* __restrict__ lo, int hdim, int din,
                     int k_tiles, long long n_chunks) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_chunks) return;
  const int phys = (int)(q % 8);
  const long long rowq = q / 8;              // global tile row
  const int r = (int)(rowq % BN);
  const long long tile = rowq / BN;
  const int kt = (int)(tile % k_tiles), nt = (int)(tile / k_tiles);
  const int n = nt * BN + r, k = kt * BK16 + 8 * (phys ^ (r % 8));
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (n < hdim && k < din) {
    const float4* src =
        reinterpret_cast<const float4*>(wq + (size_t)n * din + k);
    a = src[0];
    b = src[1];
  }
  uint4 h, l;
  if (lo != nullptr) {
    bf16_chunk<true>(a, b, h, l);
    reinterpret_cast<uint4*>(lo)[q] = l;
  } else {
    bf16_chunk<false>(a, b, h, l);
  }
  reinterpret_cast<uint4*>(hi)[q] = h;
}

// d[64] = A (smem, 64 x 16, K-major) x B (smem, 128 x 16, K-major)
// + (accumulate ? d : 0); both operands 128-byte swizzled
#define AGG_TC_WGMMA_N128(TYPE)                                              \
  asm volatile(                                                              \
      "{\n\t.reg .pred p;\n\t"                                               \
      "setp.ne.b32 p, %66, 0;\n\t"                                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "       \
      "{"                                                                    \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                     \
      "}, %64, %65, p, 1, 1, 0, 0;\n\t}"                                     \
      :                                                                      \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)                            \
      : "memory")


template <bool F16>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t desc_a,
                                           uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_n128<false>(float* d, uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  int accumulate) {
  AGG_TC_WGMMA_N128("bf16");
}

template <>
__device__ __forceinline__ void wgmma_n128<true>(float* d, uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  AGG_TC_WGMMA_N128("f16");
}

#undef AGG_TC_WGMMA_N128

// The descriptor of a 128-byte-swizzled K-major operand in shared memory
__device__ __forceinline__ uint64_t desc16(const unsigned char* p) {
  return b_desc(reinterpret_cast<const float*>(p));
}

// One k chunk of a warpgroup's tile: A's chunk at `a` and Wq's at `w`
// (three passes: their lo parts A_STAGE16 and WQ_TILE_BYTES16 further on;
// hi*lo, lo*hi, hi*hi a k-step).  Each interval of a form's k-steps runs
// into `part` on the tensor cores; once its products are done the CUDA
// cores add `part` to `acc` in f32, interval after interval in k order.
// Ends with every product of the chunk done, so its stage may be freed.
template <bool F16, int PARTS>
__device__ __forceinline__ void chunk_products16(float* acc, float* part,
                                                 const unsigned char* a,
                                                 const unsigned char* w) {
  constexpr int STEPS = PARTS == 2 ? PROMOTE_STEPS16_X3 : PROMOTE_STEPS16;
  const uint64_t da = desc16(a), db = desc16(w);
  const uint64_t da_lo = desc16(a + A_STAGE16),
                 db_lo = desc16(w + WQ_TILE_BYTES16);
#pragma unroll
  for (int k0 = 0; k0 < CHUNK_STEPS16; k0 += STEPS) {
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int ks = k0; ks < k0 + STEPS; ++ks) {  // +32 bytes a k-step
      if constexpr (PARTS == 2) {
        wgmma_n128<F16>(part, da + 2 * ks, db_lo + 2 * ks, ks > k0);
        wgmma_n128<F16>(part, da_lo + 2 * ks, db + 2 * ks, 1);
        wgmma_n128<F16>(part, da + 2 * ks, db + 2 * ks, 1);
      } else {
        wgmma_n128<F16>(part, da + 2 * ks, db + 2 * ks, ks > k0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
}

// A producer thread's share of a k chunk of A: pieces p = first + stride
// m (m < PIECES, p < BM16 * 8), each 8 elements (16-byte chunk p % 8) of
// tile row p / 8, whose id is ids[m] (< 0: a zero row).  f32 rows are
// loaded into v (16-byte loads) by `load_f32` ahead of the stage, and
// rounded (and split for three passes) into the swizzled slot `dst` by
// `store_f32`; 16-bit rows are copied by cp.async (`copy16`).
template <int PIECES>
__device__ __forceinline__ void load_f32(float4 (&v)[PIECES][2],
                                         const float* __restrict__ h,
                                         const int* ids, int din, int k,
                                         int first, int stride) {
#pragma unroll
  for (int m = 0; m < PIECES; ++m) {
    v[m][0] = v[m][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + stride * m < BM16 * 8 && ids[m] >= 0 && k < din) {
      const float4* src =
          reinterpret_cast<const float4*>(h + (size_t)ids[m] * din + k);
      v[m][0] = __ldg(src);
      v[m][1] = __ldg(src + 1);
    }
  }
}

template <int SRC, int PIECES>
__device__ __forceinline__ void store_f32(unsigned char* dst,
                                          const float4 (&v)[PIECES][2],
                                          int first, int stride) {
#pragma unroll
  for (int m = 0; m < PIECES; ++m) {
    const int p = first + stride * m, r = p / 8;
    if (p < BM16 * 8) {
      const int at = r * 128 + (((p % 8) ^ (r & 7)) << 4);
      uint4 hi, lo;
      bf16_chunk<SRC == F32_X3>(v[m][0], v[m][1], hi, lo);
      *reinterpret_cast<uint4*>(dst + at) = hi;
      if constexpr (SRC == F32_X3)
        *reinterpret_cast<uint4*>(dst + A_STAGE16 + at) = lo;
    }
  }
  // generic-proxy stores that wgmma reads through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int PIECES>
__device__ __forceinline__ void copy16(unsigned char* dst,
                                       const uint16_t* __restrict__ h,
                                       const int* ids, int din, int k,
                                       int first, int stride) {
#pragma unroll
  for (int m = 0; m < PIECES; ++m) {
    const int p = first + stride * m, r = p / 8;
    if (p < BM16 * 8) {
      const bool ok = ids[m] >= 0 && k < din;
      cp_async16(dst + r * 128 + (((p % 8) ^ (r & 7)) << 4),
                 ok ? h + (size_t)ids[m] * din + k : h, ok ? 16 : 0);
    }
  }
}

// Wq's k chunk kc of column tile ct (and, for three passes, of its lo
// tiles) into the stage at `dst` of both blocks of the cluster, this
// block copying its half (64 rows); its `bar` expects the whole stage
template <int PARTS>
__device__ __forceinline__ void copy_wq16(unsigned char* dst,
                                          const uint16_t* __restrict__ wq_t,
                                          const uint16_t* __restrict__ wq_lo_t,
                                          int ct, int kc, int k_tiles,
                                          int rank, uint64_t* bar) {
  constexpr int HALF = WQ_TILE_BYTES16 / 2;
  mbar_arrive_expect_tx(bar, PARTS * WQ_TILE_BYTES16);
  const size_t off =
      ((size_t)ct * k_tiles + kc) * (WQ_TILE_BYTES16 / 2) + rank * (HALF / 2);
  bulk_copy_multicast(dst + rank * HALF, wq_t + off, HALF, bar,
                      (1 << CLUSTER16) - 1);
  if constexpr (PARTS == 2)
    bulk_copy_multicast(dst + WQ_TILE_BYTES16 + rank * HALF, wq_lo_t + off,
                        HALF, bar, (1 << CLUSTER16) - 1);
}

// ---- the core's schedule and loop -----------------------------------------

constexpr int W_STAGES16 = 4;                  // Wq chunks of 16 KB in flight
constexpr int A_OFF16 = W_STAGES16 * WQ_TILE_BYTES16;
constexpr int A_SLOTS16 = 14;                  // k chunks of A of 8 KB
constexpr int STAGERS16 = 96;                  // producer warps 1 to 3
// a tile's epilogue costs about this many k chunks of its products
// (`choose16`): H100 timings with and without it (scripts/bf16x_ab.py
// --no-epilogue) put it at 4-8 at T = 10, and at the kernels' shapes
// `choose16` picks the same runs for any value from 2 to 10 (PERF.md)
constexpr int EPILOGUE_CHUNKS16 = 4;
// shared memory: Wq stages | A slots | per consumer warpgroup: the
// epilogue's | Wq full and empty barriers, A full and empty barriers (two
// rounds of the stages' and slots' each), order barriers
constexpr int WG_OFF16 = A_OFF16 + A_SLOTS16 * A_STAGE16;
constexpr int BAR_OFF16 = WG_OFF16 + 2 * WG_BYTES16;
constexpr int SMEM16 = SMEM_ALIGN_SLACK + BAR_OFF16 +
                       (4 * W_STAGES16 + 4 * A_SLOTS16 + 2) * 8;

static_assert(A_OFF16 % 1024 == 0 && W_STAGES16 % 2 == 0 &&
                  A_SLOTS16 % 2 == 0 && WG_OFF16 % 16 == 0 &&
                  BAR_OFF16 % 8 == 0,
              "slots 1024-byte, staging 16-byte, mbarriers 8-byte aligned");
static_assert(SMEM16 <= 232448, "the 16-bit core fits one block an SM");

// The 16-bit core's grid: resident or streamed rows, the column-tile
// runs, the items (row-tile pairs x runs) and the clusters that take them
struct Schedule16 {
  int resident, groups, items, clusters, blocks;
};

// Of the runs that split the column tiles evenly, the one whose busiest
// cluster takes the least time, in k chunks of products: a cluster's
// items one after another, each a run of tiles (k chunks of products and
// EPILOGUE_CHUNKS16 of epilogue) and its rows' staging (k chunks an item
// when resident, k a tile when streamed); ties: the longest run.  `parts`
// A slots a k chunk (2: three passes' hi and lo).
inline Schedule16 choose16(int k_tiles, int parts, int n_col_tiles,
                           long long n_row_tiles, int clusters) {
  const long long pairs = (n_row_tiles + CLUSTER16 - 1) / CLUSTER16;
  const bool resident = k_tiles <= A_SLOTS16 / parts;
  Schedule16 sc = {resident, 1, 0, clusters, 0};
  long long best = -1;
  for (int g = 1; g <= n_col_tiles; ++g) {
    if (n_col_tiles % g != 0) continue;
    const long long sweep = n_col_tiles / g;
    const long long item = sweep * (k_tiles + EPILOGUE_CHUNKS16) +
                           (resident ? k_tiles : sweep * k_tiles);
    const long long busiest = (pairs * g + clusters - 1) / clusters * item;
    if (best < 0 || busiest < best) {
      best = busiest;
      sc.groups = g;
    }
  }
  const long long items = pairs * sc.groups;
  sc.items = (int)items;
  sc.blocks = CLUSTER16 * (int)(items < clusters ? items : clusters);
  return sc;
}

// `choose16` for `kernel` on this card (one block an SM, SMEM16 bytes)
template <class Kernel>
cudaError_t schedule16(Kernel kernel, int din, int hdim, int parts,
                       long long n_row_tiles, Schedule16* sc) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM16);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER16 * 132);
  cfg.blockDim = dim3(THREADS16);
  cfg.dynamicSmemBytes = SMEM16;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  *sc = choose16((din + BK16 - 1) / BK16, parts, (hdim + BN16 - 1) / BN16,
                 n_row_tiles, clusters);
  return cudaSuccess;
}

// The 16-bit core on a block of a cluster of CLUSTER16: item i of the
// grid (cluster c takes c, c + clusters, ..) is row tiles 2 (i / groups)
// (rank 0) and that + 1 (rank 1) at column tiles (i % groups) * sweep ..
// + sweep (sweep = n_col_tiles / groups); the block's u-th tile (its u /
// sweep-th item, column u % sweep of the run) goes to consumer warpgroup
// u % 2.  Row tile rt, column tile ct is tile rt * n_col_tiles + ct: its
// rows are `row_id(tile, r)` of h (r < BM16, < 0: a zero row) and it
// reads Wq tile ct of `wq_t` (and of `wq_lo_t` for three passes).  A
// block whose pair has no second row tile multiplies zero rows and skips
// the epilogue.  SRC is TABLE16 (`h` 16-bit rows) or F32_X1 / F32_X3 (`h`
// f32 rows); Din % 8 == 0, `h` 16-byte aligned.  `resident` and `groups`
// come from `schedule16`.  A tile's warpgroup calls
// `epilogue.prefetch(tile, wg)` a tile ahead (cp.async of the epilogue's
// operands; one commit group) and `epilogue(tile, acc, wg)` with every
// product of the tile done; the epilogue's threads are the warpgroup's
// 128, which meet by `consumer_sync(wg)`.  Launched with THREADS16
// threads; `smem` is SMEM16 - SMEM_ALIGN_SLACK bytes, 1024-byte aligned,
// the epilogue's warpgroup areas at WG_OFF16.
// Stage q (Wq) and fill a (A) wait and arrive on barrier q % 2 WS and a %
// 2 AS: two rounds of barriers a stage, so that a warpgroup may wait on a
// chunk while the one WS (or AS) before it is still landing without
// mistaking an earlier phase for its own.  A warpgroup hands the turn
// over once it has waited on its chunk k_tiles - 2 WS (the first, where
// a tile has at most 2 WS chunks): every chunk up to that one has landed,
// so the other's first chunk, 2 WS further on at most, is in the
// barriers' next round (and A's, resident or 2 AS >= 2 WS further on,
// too); each later wait follows its own previous one, whose stage refill
// needed the chunk 2 WS before it consumed.
template <bool F16, int SRC, class RowId, class Epilogue>
__device__ __forceinline__ void run16(
    unsigned char* smem, const void* __restrict__ h, int din,
    const uint16_t* __restrict__ wq_t, const uint16_t* __restrict__ wq_lo_t,
    int n_col_tiles, int n_row_tiles, int groups, int resident,
    RowId row_id, Epilogue epilogue) {
  static_assert(SRC == TABLE16 || !F16, "f32 rows are rounded to bf16");
  // copies of A and of Wq a k chunk takes (hi, lo), the Wq stages and the
  // A slots of whole chunks
  constexpr int PARTS = SRC == F32_X3 ? 2 : 1;
  constexpr int WS = W_STAGES16 / PARTS, AS = A_SLOTS16 / PARTS;
  constexpr int W_STAGE = PARTS * WQ_TILE_BYTES16, A_SLOT = PARTS * A_STAGE16;
  const int tid = threadIdx.x;
  const int k_tiles = (din + BK16 - 1) / BK16;
  const int rank = cluster_special(0), cid = cluster_special(1),
            n_clusters = cluster_special(2);
  const int sweep = n_col_tiles / groups;
  const int n_items = (n_row_tiles + CLUSTER16 - 1) / CLUSTER16 * groups;
  const int n_mine = (n_items - 1 - cid) / n_clusters + 1;
  const int n_u = n_mine * sweep;              // the block's tiles
  const int n_fills = resident ? n_mine : n_u;  // times A is staged
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem + BAR_OFF16);
  uint64_t* w_empty = w_full + 2 * W_STAGES16;
  uint64_t* a_full = w_empty + 2 * W_STAGES16;  // staged, ready to multiply
  uint64_t* a_empty = a_full + 2 * A_SLOTS16;
  uint64_t* order = a_empty + 2 * A_SLOTS16;   // [wg]: its turn to multiply
  auto row_tile = [&](int j) {                 // of the block's item j
    return CLUSTER16 * ((cid + j * n_clusters) / groups) + rank;
  };
  auto col_tile = [&](int j, int v) {
    return (cid + j * n_clusters) % groups * sweep + v;
  };

  if (tid == 0) {
    for (int b = 0; b < 2 * WS; ++b) {
      mbar_init(w_full + b, 1);                // the issuer's expected bytes
      // the warps of the consuming warpgroup in both blocks: a stage is
      // refilled in both
      mbar_init(w_empty + b, CLUSTER16 * 128 / 32);
    }
    for (int b = 0; b < 2 * AS; ++b) {
      mbar_init(a_full + b, STAGERS16);
      // the warps of every tile that multiplies the fill
      mbar_init(a_empty + b, 128 / 32 * (resident ? sweep : 1));
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
    const int warp = __shfl_sync(0xffffffffu, tid % 128 / 32, 0);
    if (warp == 0) {
      // ---- Wq: chunk kc of the block's tile u into stage q % WS (q =
      // u * k_tiles + kc) once the consumers of both blocks freed it
      if (tid % 32 == 0) {
        for (int u = 0; u < n_u; ++u) {
          const int ct = col_tile(u / sweep, u % sweep);
          for (int kc = 0; kc < k_tiles; ++kc) {
            const int q = u * k_tiles + kc;
            if (q >= WS)
              mbar_wait(w_empty + (q - WS) % (2 * WS),
                        ((q - WS) / (2 * WS)) & 1);
            copy_wq16<PARTS>(smem + q % WS * W_STAGE, wq_t, wq_lo_t, ct, kc,
                             k_tiles, rank, w_full + q % (2 * WS));
          }
        }
      }
      __syncwarp();
    } else {
      // ---- stagers (warps 1-3): chunk a = f * k_tiles + kc (k chunk kc of
      // fill f: the rows of item f, or of the item of tile f when
      // streamed) goes to slot a % AS.  Stager t takes pieces t + 96 m
      // (< 512) of a chunk: 8 elements p % 8 of row p / 8 (a quarter warp
      // one row's 128 bytes of 16-bit values, 256 of f32).
      const int st = tid % 128 - 32;
      const int n_chunks = n_fills * k_tiles;
      constexpr int PIECES = (BM16 * 8 + STAGERS16 - 1) / STAGERS16;
      int ids[PIECES], next[PIECES];           // of an item, and the next's
      auto load_ids = [&](int j, int* out) {
        const int rt = row_tile(j);
        const bool ok = j < n_mine && rt < n_row_tiles;
#pragma unroll
        for (int m = 0; m < PIECES; ++m) {
          const int p = st + STAGERS16 * m;
          out[m] = ok && p < BM16 * 8 ? row_id(rt * n_col_tiles, p / 8) : -1;
        }
      };
      load_ids(0, ids);
      load_ids(1, next);
      int item = 0;                            // the item of `ids`
      // the ids of chunk a's rows in `ids`; its first column
      auto advance = [&](int a) {
        const int f = a / k_tiles;
        const int j = resident ? f : f / sweep;
        if (j != item) {                       // items advance one by one
          item = j;
#pragma unroll
          for (int m = 0; m < PIECES; ++m) ids[m] = next[m];
          load_ids(j + 1, next);
        }
        return a % k_tiles * BK16 + 8 * (st % 8);
      };
      auto slot = [&](int a) {                 // once it is free
        if (a >= AS)
          mbar_wait(a_empty + (a - AS) % (2 * AS), ((a - AS) / (2 * AS)) & 1);
        return smem + A_OFF16 + a % AS * A_SLOT;
      };
      if constexpr (SRC == TABLE16) {
        for (int a = 0; a < n_chunks; ++a) {
          const int k = advance(a);
          copy16<PIECES>(slot(a), static_cast<const uint16_t*>(h), ids, din,
                         k, st, STAGERS16);
          cp_async_arrive(a_full + a % (2 * AS));
        }
        cp_async_wait<0>();
      } else {
        const float* hf = static_cast<const float*>(h);
        auto load = [&](int a, float4 (&v)[PIECES][2]) {
          load_f32(v, hf, ids, din, advance(a), st, STAGERS16);
        };
        auto store = [&](int a, const float4 (&v)[PIECES][2]) {
          store_f32<SRC>(slot(a), v, st, STAGERS16);
          mbar_arrive(a_full + a % (2 * AS));
        };
        float4 v0[PIECES][2], v1[PIECES][2];
        if (n_chunks > 0) load(0, v0);
        for (int a = 0; a < n_chunks; a += 2) {
          if (a + 1 < n_chunks) load(a + 1, v1);
          store(a, v0);
          if (a + 1 < n_chunks) {
            if (a + 2 < n_chunks) load(a + 2, v0);
            store(a + 1, v1);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg = role: the block's tiles u = wg, wg + 2..
    const int wg = role;
    const bool leader = tid % 32 == 0;         // arrives for its warp
    // the chunk after whose wait the other warpgroup may start
    const int turn = max(0, k_tiles - 2 * WS);
    auto tile_of = [&](int u) {                // -1: no row tile
      const int j = u / sweep, rt = row_tile(j);
      return rt < n_row_tiles ? rt * n_col_tiles + col_tile(j, u % sweep)
                              : -1;
    };
    // a tile's epilogue operands are prefetched a whole tile ahead, as
    // soon as the warpgroup's last epilogue is done with its buffers
    auto prefetch = [&](int u) {
      if (u < n_u && tile_of(u) >= 0) epilogue.prefetch(tile_of(u), wg);
    };
    prefetch(wg);
    float acc[64], part[64];
    for (int u = wg; u < n_u; u += 2) {
      // the other warpgroup has waited on tile u - 1's chunk `turn`
      if (u > 0) mbar_wait(order + wg, ((u - 1) / 2) & 1);
      const int tile = tile_of(u), f = resident ? u / sweep : u;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < k_tiles; ++kc) {
        const int q = u * k_tiles + kc, a = f * k_tiles + kc;
        mbar_wait(a_full + a % (2 * AS), (a / (2 * AS)) & 1);
        mbar_wait(w_full + q % (2 * WS), (q / (2 * WS)) & 1);
        // the A copies and stores landed through the generic proxy; wgmma
        // reads them through the async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        if (kc == turn && tid % 128 == 0)
          mbar_arrive(order + (1 - wg));       // the other's turn
        chunk_products16<F16, PARTS>(acc, part,
                                     smem + A_OFF16 + a % AS * A_SLOT,
                                     smem + q % WS * W_STAGE);
        if (leader) {
          for (int r = 0; r < CLUSTER16; ++r)  // Wq: in both blocks
            mbar_arrive_cluster(w_empty + q % (2 * WS), r);
          mbar_arrive(a_empty + a % (2 * AS));
        }
      }
      if (AGG_TC_EPILOGUE && tile >= 0) epilogue(tile, acc, wg);
      prefetch(u + 2);
    }
  }
  // neither block leaves while the other may still copy into it or
  // arrive on its barriers
  cluster_sync();
}

}  // namespace agg_tc
