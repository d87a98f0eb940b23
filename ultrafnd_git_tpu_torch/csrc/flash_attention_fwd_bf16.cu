// Flash-attention forward (K2), bf16 mode, for Hopper: bf16 q, k, v and out,
// both products on the tensor cores by wgmma in bf16 with f32 accumulation,
// the softmax in f32.
//
// Replaces: ultrafnd_git_tpu/kernels/flash_attention.py::_make_fwd_kernel
// with mm_dtype=bfloat16 (launched by _pallas_forward, the default mode of
// flash_attention), as the tower runs it when it is cloned with
// dtype=bfloat16. Same outputs: s = (q k^T, f32 sums) * scale + bias in f32,
// with the (B, 1, 1, S) bf16 key-padding bias (0 or bf16(-1e9), never -inf)
// widened to f32; P = exp(s - m) rounded to bf16 for P V, which sums in f32;
// out = O / sum(P) (the f32 P; see the epilogue) rounded to bf16; lse =
// m + log(sum P) in f32.
// The TPU kernel takes each row's max over all S at once. This one keeps a
// running max over key tiles (online softmax), so past one key tile P is
// rounded to bf16 relative to a partial max: the same function, rounded at
// other points. Keys past S in a ragged last tile are excluded outright;
// masked keys keep their bias, so a fully masked row gets the uniform
// softmax and lse = bf16(-1e9) + log S, never NaN. No float atomics: two
// calls give the same bits.
//
// What bounds it on the card (computed from shapes). At the serving shape
// (256, 6, 64, 128) the call reads q, k, v (bf16) and the bias and writes
// out (bf16) and lse (f32): 101.1 MB, 0.030 ms at 3.35 TB/s (0.060 ms and
// 202 MB at the training shape (512, 6, 64, 128)); its two products are
// 3.2 GFLOP, 0.003 ms at 989 TFLOP/s of dense bf16. So the bytes set the
// bound, and the design's aim is to keep device memory busy without a gap:
// loads for the next work item are in flight while the current one
// computes and its output drains.
//
// Design (a persistent, warp-specialised TMA + wgmma kernel).
//  * Work items are (batch*head, 64-query tile). About one CTA an SM (the
//    grid is the SM count times the CTAs that fit, at most one item group a
//    CTA) walks them in a fixed order: consumer c of CTA b takes items
//    b * NC + c, then every gridDim * NC further.
//  * A CTA is one producer warpgroup and NC consumer warpgroups (NC = 2 at
//    D <= 128, 1 at D >= 192, where O alone is D / 2 registers a thread).
//    Producer warp c serves consumer c: one lane issues every load of its
//    items by TMA (cp.async.bulk.tensor.3d) and counts them on an mbarrier;
//    the producer warpgroup gives up its registers (setmaxnreg.dec from
//    168 to 40) and the consumers take them (setmaxnreg.inc to 232).
//    Two consumers an SM, each with its own producer warp and ring, rather
//    than one shared ring: an item's softmax and epilogue are chains of
//    dependent instructions, and the other consumer's products, loads and
//    store run meanwhile; the rings stay independent, so a long S in one
//    never waits on the other. scripts/fwd_bf16_schedules.py times this
//    schedule against one item a CTA with several CTAs an SM (the same
//    body); PERF.md keeps both.
//  * Each consumer has its own ring: NQ Q slots and NS stages of (K, V)
//    tiles, each with a full and an empty mbarrier. The producer loads an
//    item's Q, then its key tiles one stage each; Q stays while the key
//    tiles of a long S stream through the ring. NQ = 2 and NS = 4 / 2 / 3 /
//    2 at D = 64 / 128 / 192 / 256: with the out staging tile that is 88 /
//    112 / 216 / 224 KB a consumer, inside the 227 KB of an SM.
//  * Tensor maps. Q, K, V and out each get a 3-D map (D, S, B*H) of boxes
//    (64, 64, 1) with the 128-byte swizzle and FLOAT_OOB_FILL_NONE, so rows
//    past S read as zeros from their own head (a 2-D (B*H*S, D) view would
//    read the next head's rows) and a store clips them. A 64 x D tile is
//    D / 64 swizzle atoms of 64 rows x 128 bytes (8 KB), atom a at a * 8 KB.
//    The maps are encoded on the host for every call (the pointers change)
//    by cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//    the library links no libcuda; a failed encode returns an error.
//  * S = Q K^T is wgmma m64n64k16, A = Q and B = K from shared memory, both
//    K-major: descriptors with the 128-byte swizzle, SBO = 1024 bytes (8
//    rows of 128 bytes), LBO unused (16); a k16 step advances the start
//    address 32 bytes inside an atom, and past 64 columns by an atom.
//  * O += P V is wgmma m64nDk16 with A = P from registers: S's accumulator
//    fragments of 8-key tiles 2j and 2j + 1, packed by cvt.rn.bf16x2.f32,
//    are the A fragment of k16 step j (a warp of the warpgroup owns rows
//    16w .. 16w + 15 of both, in the m16n8k16 fragment layout). B = V from
//    shared memory, MN-major through the transpose bit: LBO = 8192 bytes
//    (the next 64 columns, one atom), SBO = 1024 (the next 8 keys); a k16
//    step advances 16 keys, 2048 bytes.
//  * The S product is waited (wgmma.wait_group 0) before it is scaled,
//    biased, exponentiated and packed; the P V product before the stage is
//    released. The bias is read by threads (it is (B, S) bf16 with S any
//    length) and never past S.
//  * Epilogue: out = O * (1 / l) (within an f32 ulp of O / l, which the
//    TPU kernel and the twin compute, so on rare elements the bf16 rounding
//    lands one bf16 ulp away from theirs; 2 divisions a thread, not D / 2,
//    which held a consumer back) rounded to bf16 into
//    a staging tile in the out map's swizzled layout (16-byte chunk i ^
//    row % 8, no bank conflicts), fence.proxy.async, then one thread
//    stores it by TMA
//    (cp.async.bulk.tensor ... .global.shared::cta, a bulk group) and the
//    consumer goes on to its next item; before the staging tile is written
//    again that thread waits for the store to have read it
//    (cp.async.bulk.wait_group.read 0). lse goes from registers.
//
// chip_smoke.py prints the ptxas report and the dynamic shared memory of
// each width; PERF.md keeps the times. tests/test_torch_fwd_design.py
// emulates the kernel in numpy from the constants below.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

// TMA boxes and wgmma descriptors (bytes)
constexpr int kBox = 64;                // box: 64 columns (128 bytes) x 64 rows
constexpr uint32_t kAtomBytes = 8192;   // one swizzle atom: 64 rows x 128 bytes
constexpr uint32_t kSwizzleMode = 1;    // descriptor layout type: 128-byte swizzle
constexpr uint32_t kQKLbo = 16;         // K-major Q, K: unused with the swizzle
constexpr uint32_t kQKSbo = 1024;       // K-major Q, K: next 8 rows
constexpr uint32_t kKStepBytes = 32;    // K-major k16 step inside an atom
constexpr uint32_t kVLbo = 8192;        // MN-major V: next 64 columns (an atom)
constexpr uint32_t kVSbo = 1024;        // MN-major V: next 8 keys
constexpr uint32_t kVStepBytes = 2048;  // MN-major V k16 step: 16 keys
constexpr int kTnspV = 1;               // V is MN-major: the transpose bit of B

template <int D>
struct Cfg {
  static constexpr int NC = D <= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int NQ = 2;                 // Q slots a consumer
  static constexpr int NS = D == 64 ? 4 : (D == 128 ? 2 : (D == 192 ? 3 : 2));  // (K, V) stages
  static constexpr int kThreads = 128 * (NC + 1);     // launched
  static constexpr int kConsumerRegs = 232;           // from 168 at entry, see the kernel
  static constexpr int kProducerRegs = 40;
  static constexpr int ATOMS = D / kBox;              // swizzle atoms across D
  static constexpr uint32_t TILE = ATOMS * kAtomBytes;  // one 64 x D bf16 tile
  static constexpr uint32_t PER_C = (NQ + 1 + 2 * NS) * TILE;  // Q slots, out, stages
  static constexpr int NB = 2 * NQ + 2 * NS;          // mbarriers a consumer
  static constexpr size_t SMEM = 1024 + NC * PER_C + 8 * NC * NB;  // + alignment slack
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

// one (64, 64, 1) box at (c0, c1, c2) of a 3-D map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma matrix descriptor: start address, LBO and SBO (bytes, 16-byte
// units in the fields), the swizzle mode in bits 62-63
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)kSwizzleMode << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64 x n64, f32) (+)= A B^T: A (64 x 16) and B (64 x 16) bf16, both
// K-major in shared memory through descriptors; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTnspV));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTnspV));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTnspV));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTnspV));
}


// bf16x2 of (lo, hi), each rounded to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  if constexpr (D == 192) wgmma_rs_n192(o, a, db);
  if constexpr (D == 256) wgmma_rs_n256(o, a, db);
}

// Launch bounds of three warpgroups for every width: 168 registers a thread
// at entry (a wgmma of n256 alone needs more than 128), one CTA an SM; at
// D >= 192 only two warpgroups are launched.
template <int D>
__global__ void __launch_bounds__(384, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap, const bf16* __restrict__ bias,
                      float* __restrict__ lse, int heads, int seq, int n_items, float scale) {
  using C = Cfg<D>;
  constexpr int NC = C::NC, NQ = C::NQ, NS = C::NS, NB = C::NB;
  constexpr uint32_t TILE = C::TILE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t bars = base + NC * C::PER_C;
  // consumer c's region: Q slots 0 .. NQ - 1, the out staging tile, then
  // stage s's K and V; its barriers: Q full, Q empty, KV full, KV empty
  auto q_slot = [&](int c, int s) { return base + c * C::PER_C + s * TILE; };
  auto o_tile = [&](int c) { return base + c * C::PER_C + NQ * TILE; };
  auto k_slot = [&](int c, int s) { return base + c * C::PER_C + (NQ + 1 + 2 * s) * TILE; };
  auto v_slot = [&](int c, int s) { return k_slot(c, s) + TILE; };
  auto q_full = [&](int c, int s) { return bars + 8 * (c * NB + s); };
  auto q_empty = [&](int c, int s) { return bars + 8 * (c * NB + NQ + s); };
  auto kv_full = [&](int c, int s) { return bars + 8 * (c * NB + 2 * NQ + s); };
  auto kv_empty = [&](int c, int s) { return bars + 8 * (c * NB + 2 * NQ + NS + s); };

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int tiles = (seq + kBox - 1) / kBox;  // query tiles of a head, and key tiles of S

  if (threadIdx.x == 0) {
    for (int c = 0; c < NC; ++c) {
      for (int s = 0; s < NQ; ++s) {
        mbar_init(q_full(c, s), 1);   // the producer's expect_tx
        mbar_init(q_empty(c, s), 4);  // one arrival a consumer warp
      }
      for (int s = 0; s < NS; ++s) {
        mbar_init(kv_full(c, s), 1);
        mbar_init(kv_empty(c, s), 4);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: warp c's lane 0 loads consumer c's items
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (warp < NC && lane == 0) {
      const int c = warp;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&qmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vmap)) : "memory");
      int k = 0;
      for (int item = blockIdx.x * NC + c; item < n_items; item += gridDim.x * NC, ++k) {
        const int bh = item / tiles, q0 = (item - bh * tiles) * kBox;
        const int qs = k % NQ;
        mbar_wait(q_empty(c, qs), ((k / NQ) & 1) ^ 1);
        mbar_expect_tx(q_full(c, qs), TILE);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a)
          tma_load(q_slot(c, qs) + a * kAtomBytes, &qmap, q_full(c, qs), a * kBox, q0, bh);
        for (int kt = 0; kt < tiles; ++kt) {
          const int n = k * tiles + kt, st = n % NS;
          mbar_wait(kv_empty(c, st), ((n / NS) & 1) ^ 1);
          mbar_expect_tx(kv_full(c, st), 2 * TILE);
#pragma unroll
          for (int a = 0; a < C::ATOMS; ++a) {
            tma_load(k_slot(c, st) + a * kAtomBytes, &kmap, kv_full(c, st), a * kBox, kt * kBox, bh);
            tma_load(v_slot(c, st) + a * kAtomBytes, &vmap, kv_full(c, st), a * kBox, kt * kBox, bh);
          }
        }
      }
    }
  } else {
    // consumer c: warp w owns query rows 16w .. 16w + 15 of each item; a
    // lane holds rows g and g + 8 at columns 8i + 2tq, 8i + 2tq + 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int c = wg - 1, g = lane >> 2, tq = lane & 3;
    int k = 0;
    for (int item = blockIdx.x * NC + c; item < n_items; item += gridDim.x * NC, ++k) {
      const int bh = item / tiles, q0 = (item - bh * tiles) * kBox;
      const bf16* brow = bias + (size_t)(bh / heads) * seq;
      const int qs = k % NQ;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      mbar_wait(q_full(c, qs), (k / NQ) & 1);
      for (int kt = 0; kt < tiles; ++kt) {
        const int n = k * tiles + kt, st = n % NS, k0 = kt * kBox;
        // this thread's keys of the tile, 8j + 2tq + {0, 1}: bias, in flight
        // during the wait and the product
        float bk[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * tq + e;
            bk[j][e] = key < seq ? __bfloat162float(brow[key]) : -INFINITY;
          }
        mbar_wait(kv_full(c, st), (n / NS) & 1);

        // S = Q K^T: 64 rows x 64 keys, D / 16 k16 steps
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * kAtomBytes + (kk % 4) * kKStepBytes;
          wgmma_ss_n64(s, desc(q_slot(c, qs) + off, kQKLbo, kQKSbo),
                       desc(k_slot(c, st) + off, kQKLbo, kQKSbo), kk > 0);
        }
        wgmma_commit_and_wait();
        fence_regs(s);
        if (kt == tiles - 1 && lane == 0) mbar_arrive(q_empty(c, qs));  // Q read for the last time

        // online softmax on the fragments: rows g (h = 0) and g + 8 (h = 1),
        // each spread over the 4 lanes of a quad
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // a key past S has bias -inf, so x = -inf there: s is finite
            const float x = __fadd_rn(__fmul_rn(s[4 * j + e], scale), bk[j][e & 1]);
            s[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          mx[h] = fmaxf(m[h], mx[h]);     // finite: key k0 < seq is in every tile
          alpha[h] = expf(m[h] - mx[h]);  // 0 on the first tile
          m[h] = mx[h];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(s[4 * j + e] - m[e >> 1]);  // 0 past S
            s[4 * j + e] = p;
            sum[e >> 1] += p;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          l[h] = l[h] * alpha[h] + sum[h];
        }
        if (kt > 0) {  // on the first tile O is 0 (and alpha 0)
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        }

        // O += P V, one k16 step per 16 keys: S's fragments of 8-key tiles 2j
        // and 2j + 1, packed to bf16, are the step's A fragment
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pa[j][0] = pack(s[8 * j + 0], s[8 * j + 1]);
          pa[j][1] = pack(s[8 * j + 2], s[8 * j + 3]);
          pa[j][2] = pack(s[8 * j + 4], s[8 * j + 5]);
          pa[j][3] = pack(s[8 * j + 6], s[8 * j + 7]);
        }
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_pv<D>(o, pa[j], desc(v_slot(c, st) + j * kVStepBytes, kVLbo, kVSbo));
        wgmma_commit_and_wait();
        fence_regs(o);
        if (lane == 0) mbar_arrive(kv_empty(c, st));  // K and V of the stage read
      }

      // epilogue: out = O / l as bf16 into the staging tile, in the out map's
      // swizzled layout, then one TMA store; lse from registers
      if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync(1 + c);  // the previous item's store has read the tile
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const float inv = 1.f / l[h];
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const uint32_t addr =
              o_tile(c) + (i / 8) * kAtomBytes + r * 128 + (((i % 8) ^ (r & 7)) << 4) + tq * 4;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                       "r"(pack(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv))
                       : "memory");
        }
        if (tq == 0 && q0 + r < seq) lse[(size_t)bh * seq + q0 + r] = m[h] + logf(l[h]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + c);  // the tile is written
      if (t == 0) {
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a) tma_store(&omap, o_tile(c) + a * kAtomBytes, a * kBox, q0, bh);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// A 3-D map (D, S, B*H) of a contiguous (B*H, S, D) bf16 tensor, boxes of
// (64, 64, 1), 128-byte swizzle, rows past S read as zeros and not written.
int encode(CUtensorMap* map, const void* ptr, int dim, int seq, long long bh) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t size[3] = {(cuuint64_t)dim, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t stride[2] = {(cuuint64_t)dim * sizeof(bf16), (cuuint64_t)seq * dim * sizeof(bf16)};
  const cuuint32_t box[3] = {kBox, kBox, 1}, unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), size,
                          stride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed - (int)res;
}

// Per device: the dynamic shared memory attribute of width D (set once) and
// how many CTAs of it the card holds at once (SMs x CTAs an SM).
template <int D>
cudaError_t resident_ctas(int* out) {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (*out = cached[dev].load()) > 0) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_fwd_bf16_kernel<D>,
                                                      Cfg<D>::kThreads, Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  if (dev < 64) cached[dev].store(*out);
  return cudaSuccess;
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* bias, bf16* out,
           float* lse, int batch, int heads, int seq, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const long long bh = (long long)batch * heads, tiles = (seq + kBox - 1) / kBox;
  if (bh * tiles > 0x7fffffffLL - 2LL * 65536 * C::NC) return cudaErrorInvalidValue;
  const int n_items = (int)(bh * tiles);
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i) {
    const int err = encode(&maps[i], ptrs[i], D, seq, bh);
    if (err != 0) return err;
  }
  int ctas = 0;
  const cudaError_t err = resident_ctas<D>(&ctas);
  if (err != cudaSuccess) return err;
  const int groups = (n_items + C::NC - 1) / C::NC;  // one item a consumer
  const int grid = groups < ctas ? groups : ctas;
  flash_fwd_bf16_kernel<D><<<grid, C::kThreads, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bias, lse, heads, seq, n_items, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v, out: contiguous
// (B, H, S, D) bf16, 16-byte aligned (TMA); bias: contiguous (B, S) bf16;
// lse: (B, H, S) f32. Returns 0 when launched, else the cudaError_t of the
// launch, kNoEncoder (-1) when libcuda has no cuTensorMapEncodeTiled, or
// -1000 - CUresult when a tensor map does not encode.
extern "C" int ufnd_flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                             const void* bias, void* out, float* lse,
                                             int batch, int heads, int seq, int dim,
                                             float scale, void* stream) {
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v), *b_ = static_cast<const bf16*>(bias);
  bf16* o_ = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 64: return launch<64>(q_, k_, v_, b_, o_, lse, batch, heads, seq, scale, s);
    case 128: return launch<128>(q_, k_, v_, b_, o_, lse, batch, heads, seq, scale, s);
    case 192: return launch<192>(q_, k_, v_, b_, o_, lse, batch, heads, seq, scale, s);
    case 256: return launch<256>(q_, k_, v_, b_, o_, lse, batch, heads, seq, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of the kernel at head width `dim` (bytes), -1
// for a width it does not take.
extern "C" int ufnd_flash_attention_fwd_bf16_smem(int dim) {
  switch (dim) {
    case 64: return (int)Cfg<64>::SMEM;
    case 128: return (int)Cfg<128>::SMEM;
    case 192: return (int)Cfg<192>::SMEM;
    case 256: return (int)Cfg<256>::SMEM;
    default: return -1;
  }
}
