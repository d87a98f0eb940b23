// The BERT rung's linear products in 3xTF32 on Hopper's tensor cores:
// Y[M, N] = X[M, K] W^T + b in f32, with the exact-erf GELU of
// `intermediate.dense` in the epilogue on request (`models/bert.
// PackedBertLayer`: q/k/v as one N = 3W product, the attention output, the
// intermediate and the output denses).
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA.
// It was added because the configuration states f32 with TF32 off, so
// cuBLAS runs them on the CUDA cores (67 TFLOP/s), where the BERT cells
// spent 85-89% of their device time; 3xTF32 keeps f32 accuracy at a
// ceiling of 495 / 3 = 165 TFLOP/s.
//
// 3xTF32 (the split of tf32_mma.cuh). Each operand is x = hi + lo, hi = x
// rounded to TF32 (half an ulp added, the low 13 bits cleared), lo = x - hi
// (exact; the tensor core reads its top 19 bits), and X W^T ~ X_lo W_hi^T +
// X_hi W_lo^T + X_hi W_hi^T. W is split once, when the encoder is built
// (`kernels/gemm_tf32x3.split_tf32`, the same bits): W_hi and W_lo come in
// as two (N, K) tensors. X is split here, in registers.
//
// Sums. The tensor cores add into their accumulator with truncation, so a
// sum kept there across all of K drifts: 4-10x cuBLAS f32's gap to an f64
// product at bert-base's widths (on an H100; PERF.md §6). Here each 32-deep
// stage's three terms start from zero in the tensor cores and the stage's
// sum is added to an f32 accumulator in registers (round to nearest): 0.2-
// 0.4x cuBLAS's gap from M = 1,000 up. Under 129 rows the kernel is
// latency-bound and cuBLAS's small-M path is near exactly rounded, so there
// each k8 step's sum is added with compensation (Kahan) instead.
//
// What bounds it on the card (computed from shapes). At M = 16,384 (an ocr
// chunk, 64 x 256) the four products of a layer are 2.32e11 FLOP, counted
// once: 0.47 ms at 495 TFLOP/s of TF32, 1.41 ms for the three TF32 passes
// 3xTF32 runs; their bytes (X, W, b, Y in f32, each once) 0.30 GB, 0.09 ms
// at 3.35 TB/s. So the tensor cores set the bound, and the design's aim is
// to keep them busy: loads in flight ahead of the products, the split, the
// f32 sums and the epilogue beside them.
//
// Design (a persistent, warp-specialised TMA + wgmma kernel).
//  * Output tiles are 128 x BN, BN = 128, 96 or 64 (`pick` chooses from M
//    and N by the waves of the SMs it fills, each shape at its own rate);
//    about one CTA an SM walks them, N fastest, so the CTAs in flight share
//    the rows of X in L2 and W stays there whole (bert-base's largest W_hi
//    + W_lo, 18.9 MB, under 50 MB).
//  * A CTA is one producer warpgroup and two consumer warpgroups of 64 rows
//    each. One lane of the producer issues every load by TMA into a ring of
//    NS stages, a stage being the X tile (128 x 32), the W_hi tile and the
//    W_lo tile (BN x 32 each) of one 32-deep slice of K, counted on a full
//    mbarrier; the consumers release a stage on its empty mbarrier (lane 0
//    of each of their 8 warps). 192 KB of stages: 4 / 4 / 6 of 48 / 40 /
//    32 KB. The producer warpgroup gives up registers (setmaxnreg.dec to
//    40), the consumers take them (setmaxnreg.inc to 232).
//  * Tensor maps. X is a 2-D map (K, M), W_hi and W_lo (K, N), boxes of 32
//    columns (128 bytes) x 128 or BN rows, the 128-byte swizzle (16-byte
//    chunk q of row r at q ^ (r % 8)), FLOAT_OOB_FILL_NONE: rows past M or N
//    read as zeros, so a ragged M or N needs no other care on the way in.
//    The maps are encoded on the host for every call by
//    cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//    -lcuda).
//  * The products are wgmma m64nBNk8 .tf32 with A from registers and B = W
//    from shared memory, K-major (the only layout .tf32 takes): descriptors
//    with the 128-byte swizzle, SBO = 1024 bytes (8 rows of 128 bytes), LBO
//    unused (16), a k8 step 32 bytes into the row. A consumer thread reads
//    its A fragments of a k8 step from the X tile (a0 (g, t), a1 (g + 8,
//    t), a2 (g, t + 4), a3 (g + 8, t + 4) of its warp's 16 rows, the
//    m16n8k8 layout; 32 distinct banks a load under the swizzle), splits
//    them, and issues lo * hi, hi * lo, hi * hi. A stage's 12 products are
//    one group; the consumer waits for it, releases the stage and adds the
//    sum while the other consumer's group runs, so the two take turns on
//    the tensor cores.
//  * Epilogue, straight from the f32 accumulators: + b, then the GELU
//    (x / 2 (1 + erf(x / sqrt 2)) in f32, as F.gelu computes it) where asked,
//    stored as float2 pairs, rows past M and columns past N left out. A
//    consumer runs a tile's epilogue once it has issued the next tile's
//    first group, so the tensor cores work through it.
//
// chip_smoke.py prints the ptxas report and times each product against its
// bound, its plain version and F.linear. tests/test_torch_fwd_design.py
// emulates the kernel in numpy from the constants below.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "tf32_mma.cuh"

namespace {

// TMA boxes and wgmma descriptors (bytes)
constexpr int kBM = 128;               // rows of a tile: two consumer warpgroups of 64
constexpr int kBK = 32;                // depth of a stage: 32 f32, one 128-byte swizzle row
constexpr uint32_t kRowBytes = 128;    // a tile row of kBK f32
constexpr uint32_t kSwizzleMode = 1;   // descriptor layout type: 128-byte swizzle
constexpr uint32_t kLbo = 16;          // K-major: unused with the swizzle
constexpr uint32_t kSbo = 1024;        // K-major: next 8 rows
constexpr uint32_t kStepBytes = 32;    // a k8 step (8 f32) inside the row
constexpr uint32_t kStageBudget = 196608;  // shared memory for the ring: 192 KB
constexpr int kKahanRows = 128;        // up to this M, a compensated sum a k8 step

template <int BN>
struct Cfg {
  static constexpr int NA = BN / 2;                  // accumulators a thread
  static constexpr uint32_t X_BYTES = kBM * kRowBytes;
  static constexpr uint32_t W_BYTES = BN * kRowBytes;
  static constexpr uint32_t STAGE = X_BYTES + 2 * W_BYTES;
  static constexpr int NS = kStageBudget / STAGE;    // stages of the ring
  static constexpr int kThreads = 384;               // producer + 2 consumer warpgroups
  static constexpr int kConsumerRegs = 232;          // from 168 at entry
  static constexpr int kProducerRegs = 40;
  static constexpr size_t SMEM = 1024 + NS * STAGE + 16 * NS;  // + alignment slack, barriers
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box at (c0, c1) of a 2-D map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma matrix descriptor of a K-major tile: start address, LBO and SBO
// (bytes, 16-byte units in the fields), the swizzle mode in bits 62-63
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(kLbo >> 4) << 16 |
         (uint64_t)(kSbo >> 4) << 32 | (uint64_t)kSwizzleMode << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64 x nBN, f32) (+)= A B^T: A (64 x 8) TF32 from registers, B (BN x 8)
// TF32, K-major in shared memory through a descriptor; scale_d = 0
// overwrites d
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t db,
                                      int scale_d = 1) {
  if constexpr (BN == 64) wgmma_n64(d, a, db, scale_d);
  if constexpr (BN == 96) wgmma_n96(d, a, db, scale_d);
  if constexpr (BN == 128) wgmma_n128(d, a, db, scale_d);
}

// A fragments (hi, lo) of k8 step kk for the 16 rows of a warp, from the X
// tile of a stage (rows of 128 bytes, 16-byte chunk q of row r at q ^ (r %
// 8)); r is the row of a0 (r % 8 == g), rows r and r + 8 share r % 8
__device__ __forceinline__ void load_x(const float* xs, int r, int kk, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* row = xs + r * kBK;
  const int c0 = ((((2 * kk) ^ (r & 7))) << 2) + t;      // column 8 kk + t
  const int c1 = ((((2 * kk + 1) ^ (r & 7))) << 2) + t;  // column 8 kk + t + 4
  split(row[c0], hi[0], lo[0]);
  split(row[8 * kBK + c0], hi[1], lo[1]);
  split(row[c1], hi[2], lo[2]);
  split(row[8 * kBK + c1], hi[3], lo[3]);
}

__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752440f));
}

// Launch bounds of three warpgroups: 168 registers a thread at entry, one
// CTA an SM. KAHAN: a compensated sum of each k8 step's products (the
// kernel under kKahanRows rows); else a plain f32 sum of each stage's.
template <int BN, bool KAHAN>
__global__ void __launch_bounds__(384, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap lmap, const float* __restrict__ bias,
                   float* __restrict__ y, int m, int n, int k, int gelu) {
  using C = Cfg<BN>;
  constexpr int NS = C::NS, NA = C::NA;
  constexpr int GROUP = KAHAN ? 1 : kBK / 8;  // k8 steps a sum in the tensor cores
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms: 1 KB aligned
  unsigned char* sbase = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sbase);
  const uint32_t bars = base + NS * C::STAGE;
  // stage s: the X tile, the W_hi tile, the W_lo tile; its barriers: full, empty
  auto x_slot = [&](int s) { return base + s * C::STAGE; };
  auto h_slot = [&](int s) { return x_slot(s) + C::X_BYTES; };
  auto l_slot = [&](int s) { return h_slot(s) + C::W_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = ((m + kBM - 1) / kBM) * n_tiles;
  const int steps = k / kBK;  // stages a tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx
      mbar_init(empty(s), 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one lane loads every stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (warp == 0 && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&hmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&lmap)) : "memory");
      int it = 0;  // stages issued
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * BN;
        for (int ks = 0; ks < steps; ++ks, ++it) {
          const int s = it % NS;
          mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
          mbar_expect_tx(full(s), C::STAGE);
          tma_load(x_slot(s), &xmap, full(s), ks * kBK, m0);
          tma_load(h_slot(s), &hmap, full(s), ks * kBK, n0);
          tma_load(l_slot(s), &lmap, full(s), ks * kBK, n0);
        }
      }
    }
  } else {
    // consumer c: rows 64 c .. 64 c + 63 of each tile; warp w holds rows
    // 16 w + g and 16 w + g + 8 of them, columns 8 i + 2 tq and 8 i + 2 tq + 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int c = wg - 1, g = lane >> 2, tq = lane & 3;
    const int row0 = 64 * c + 16 * warp + g;  // the a0 row in the tile
    int it = 0;  // stages consumed
    float acc[NA], tc[NA], comp[KAHAN ? NA : 1];  // the f32 sum, the tensor cores' sum, Kahan's
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      tc[i] = acc[i] = 0.f;
      if constexpr (KAHAN) comp[i] = 0.f;
    }
    // epilogue of the tile at (m0, n0) from acc: + b, the GELU where asked,
    // float2 stores; rows past M and columns past N are left out. Then acc
    // (and Kahan's term) start again from zero.
    auto epilogue = [&](int m0, int n0) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * tq;
        if (col < n) {  // n is even: col + 1 < n too
          const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + row0 + 8 * h;
            if (row >= m) continue;
            float v0 = acc[4 * i + 2 * h] + b.x, v1 = acc[4 * i + 2 * h + 1] + b.y;
            if (gelu) {
              v0 = gelu_erf(v0);
              v1 = gelu_erf(v1);
            }
            *reinterpret_cast<float2*>(y + (size_t)row * n + col) = make_float2(v0, v1);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[4 * i + e] = 0.f;
          if constexpr (KAHAN) comp[4 * i + e] = 0.f;
        }
      }
    };
    int last_m0 = -1, last_n0 = 0;  // the tile whose epilogue is pending
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * BN;
      for (int ks = 0; ks < steps; ++ks, ++it) {
        const int s = it % NS;
        mbar_wait(full(s), (it / NS) & 1);
        const float* xs = reinterpret_cast<const float*>(sbase + s * C::STAGE);
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          uint32_t ah[4], al[4];
          load_x(xs, row0, kk, tq, ah, al);
          const uint64_t dh = desc(h_slot(s) + kk * kStepBytes);
          const uint64_t dl = desc(l_slot(s) + kk * kStepBytes);
          wgmma_fence();
          wgmma<BN>(tc, al, dh, kk % GROUP);  // lo * hi, from 0 at a group's first step
          wgmma<BN>(tc, ah, dl);              // hi * lo
          wgmma<BN>(tc, ah, dh);              // hi * hi
          if (kk % GROUP == GROUP - 1) {
            wgmma_commit();
            // the tile before's epilogue, while this tile's first group runs
            if (ks == 0 && kk == GROUP - 1 && last_m0 >= 0) epilogue(last_m0, last_n0);
            wgmma_wait<0>();
            if (kk == kBK / 8 - 1 && lane == 0) mbar_arrive(empty(s));  // the stage is read
            fence_regs(tc);
#pragma unroll
            for (int i = 0; i < NA; ++i) {
              if constexpr (KAHAN) {
                const float yv = tc[i] - comp[i];
                const float tv = acc[i] + yv;
                comp[i] = (tv - acc[i]) - yv;
                acc[i] = tv;
              } else {
                acc[i] += tc[i];
              }
            }
          }
        }
      }
      last_m0 = m0;
      last_n0 = n0;
    }
    if (last_m0 >= 0) epilogue(last_m0, last_n0);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no link)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Errors of the host side, beside the cudaError_t of a launch: no encoder in
// libcuda, or a failed encode (kEncodeFailed - its CUresult).
constexpr int kNoEncoder = -1;
constexpr int kEncodeFailed = -1000;

// A 2-D map (K, rows) of a contiguous (rows, K) f32 matrix, boxes of (32,
// box_rows), 128-byte swizzle, rows past the end read as zeros.
int encode(CUtensorMap* map, const void* ptr, int k, int rows, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t size[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)k * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), size,
                          stride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed - (int)res;
}

// The SM count of the current device (cached a device).
cudaError_t sm_count(int* out) {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (*out = cached[dev].load()) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cached[dev].store(*out);
  return err;
}

template <int BN, bool KAHAN>
int launch(const float* x, const float* wh, const float* wl, const float* b, float* y, int m,
           int n, int k, int gelu, cudaStream_t stream) {
  using C = Cfg<BN>;
  static std::atomic<bool> attr_set[64];  // the shared memory attribute, once a device
  CUtensorMap maps[3];
  int err = encode(&maps[0], x, k, m, kBM);
  if (err == 0) err = encode(&maps[1], wh, k, n, BN);
  if (err == 0) err = encode(&maps[2], wl, k, n, BN);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !attr_set[dev].load()) {
    e = cudaFuncSetAttribute(gemm_tf32x3_kernel<BN, KAHAN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 64) attr_set[dev].store(true);
  }
  e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)((m + kBM - 1) / kBM) * ((n + BN - 1) / BN);
  const int grid = tiles < sms ? (int)tiles : sms;
  gemm_tf32x3_kernel<BN, KAHAN><<<grid, C::kThreads, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], b, y, m, n, k, gelu);
  return cudaGetLastError();
}

// The tile widths, and each one's rate over the widest's at full waves
// (measured on an H100 80GB HBM3 at M = 16,384, bert-base's four products:
// about 118, 100 and 96 TFLOP/s): a narrower tile reads more bytes a product.
constexpr int kShapes = 3;
constexpr int kShapeBN[kShapes] = {128, 96, 64};
constexpr double kShapeRate[kShapes] = {1.0, 0.85, 0.81};

// The width of least time: waves of `sms` CTAs, each a tile's area at its
// rate; on a tie, the wider tile. Under kKahanRows rows, shape 3: 64 wide,
// compensated sums.
int pick(int m, int n, int sms) {
  if (m <= kKahanRows) return kShapes;
  int best = 0;
  double best_cost = 0.0;
  for (int i = 0; i < kShapes; ++i) {
    const long long tiles = (long long)((m + kBM - 1) / kBM) * ((n + kShapeBN[i] - 1) / kShapeBN[i]);
    const long long waves = (tiles + sms - 1) / sms;
    const double cost = (double)waves * kShapeBN[i] / kShapeRate[i];
    if (i == 0 || cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

// The tile shape the kernel takes at (m, n) on the current device: 0, 1, 2
// (128 x 128, 96, 64) or 3 (128 x 64, compensated sums); below 0 a
// cudaError_t, negated.
extern "C" int ufnd_gemm_tf32x3_shape(int m, int n) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  return e == cudaSuccess ? pick(m, n, sms) : -(int)e;
}

// Plain C entry point (loaded with ctypes). x: contiguous (m, k) f32; w_hi,
// w_lo: contiguous (n, k) f32, W split as tf32_mma.cuh's split; bias: (n)
// f32; y: contiguous (m, n) f32; all 16-byte aligned (TMA). n % 64 == 0, k %
// 32 == 0, m >= 1. gelu: apply the exact-erf GELU after the bias. shape: one
// of ufnd_gemm_tf32x3_shape's, or -1 for its choice. Returns 0 when
// launched, else the cudaError_t of the launch (cudaErrorInvalidValue for
// arguments it does not take), kNoEncoder (-1) when libcuda has no
// cuTensorMapEncodeTiled, or -1000 - CUresult when a map does not encode.
extern "C" int ufnd_gemm_tf32x3(const void* x, const void* w_hi, const void* w_lo,
                                const void* bias, void* y, int m, int n, int k, int gelu,
                                int shape, void* stream) {
  const float *x_ = static_cast<const float*>(x), *h_ = static_cast<const float*>(w_hi),
              *l_ = static_cast<const float*>(w_lo), *b_ = static_cast<const float*>(bias);
  float* y_ = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 64 || n % 64 || k < kBK || k % kBK || shape < -1 || shape > kShapes)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[5] = {x, w_hi, w_lo, bias, y};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if (shape < 0) {
    shape = ufnd_gemm_tf32x3_shape(m, n);
    if (shape < 0) return -shape;
  }
  switch (shape) {
    case 0: return launch<128, false>(x_, h_, l_, b_, y_, m, n, k, gelu, s);
    case 1: return launch<96, false>(x_, h_, l_, b_, y_, m, n, k, gelu, s);
    case 2: return launch<64, false>(x_, h_, l_, b_, y_, m, n, k, gelu, s);
    default: return launch<64, true>(x_, h_, l_, b_, y_, m, n, k, gelu, s);
  }
}
