// Flash-attention backward, bf16 mode, for Hopper: dQ, dK, dV and the dbias
// partials in one pass, every product on the tensor cores in bf16 with f32
// sums.
//
// Replaces: ultrafnd_git_tpu/kernels/flash_attention.py::_make_bwd_dq_kernel
// (K3) and ::_make_bwd_dkv_kernel (K4) with mm_dtype=bfloat16 (the default
// mode of flash_attention), both launched by _pallas_backward, with one
// kernel and one launch per backward call; the training path reaches it
// under bf16_compute. Same arithmetic, in this order: q, k, v, O, dO bf16;
// the (B, 1, 1, S) bf16 bias widened to f32; lse f32;
//   s = (q k^T, f32 sums) * scale + bias, P = exp(s - lse)  (f32)
//   dP = dO v^T (f32 sums), delta = rowsum(f32(dO) f32(O)), dS = P (dP - delta)
//   dQ = bf16(dS) k * scale, dK = bf16(dS)^T q * scale, dV = bf16(P)^T dO,
// each summed in f32 and rounded to bf16 once (round to nearest even); the
// dbias partial of a (batch*head, key) is the f32 sum of the unrounded dS
// over every query row. Pallas computes delta outside its kernels; this one
// computes it in the pass. When S spans several key blocks, each block's dQ
// goes out in f32 to a (ceil(S / BK), B*H, S, D) slab, and the wrapper
// (kernels/flash_attention.py::flash_attention_bwd_bf16) sums the slabs and
// then rounds to bf16 once, as Pallas rounds the whole dQ once; it also sums
// the dbias partials over heads. No float atomics: two calls give the same
// bits.
//
// Design. One CTA of 8 warps per (batch*head, block of BK keys): BK = 64 at
// D <= 128, 32 at D = 192 and 256. At the training path's S = 64 that is one
// CTA per (b, h) holding every key. The CTA stages its K and V once in shared
// memory (cp.async, 16 bytes a thread) and walks the query tiles (BQ = 64) of
// Q and dO. Per tile:
//  * delta and lse of the tile's rows into shared memory (4 lanes a row,
//    16-byte loads of O and dO, while the copies land);
//  * S = Q K^T and dP = dO V^T: warp w takes rows 16 (w / 2) and keys
//    (w % 2) BK / 2; A fragments (Q, dO) by ldmatrix.x4, B fragments (K, V
//    rows: the product wants them column-major, which rows are) by
//    ldmatrix.x4;
//  * P and dS on the accumulator fragments in f32; each packed to bf16 in
//    pairs (cvt.rn.bf16x2.f32) and stored to a (BQ, BK) shared tile; the
//    dbias sums taken from the f32 dS by warp shuffles over the 8 rows of a
//    fragment, accumulated per warp across tiles;
//  * dV += P^T dO and dK += dS^T Q, accumulated in registers across tiles:
//    warp w takes 16 keys and D / NPART columns. The A fragments are P and
//    dS transposed: ldmatrix.x4.trans of the query-major tiles gives exactly
//    them. The B fragments (dO, Q with the query as the reduction index) by
//    ldmatrix.x4.trans too;
//  * the next tile's Q and dO start loading while
//  * dQ = dS K of the tile: warp w takes rows 16 (w / 2) and columns
//    (w % 2) D / 2 in chunks of 32; dS's A fragments by ldmatrix.x4 (a row of
//    dS spans both key halves, so not from one warp's registers), K's B
//    fragments by ldmatrix.x4.trans; written as bf16 when the CTA holds every
//    key, else as f32 to its key block's slab.
// Every tile is XOR-swizzled in 16-byte chunks so that the 8 row addresses
// of each ldmatrix phase fall in 8 distinct bank groups: chunk ^ (row % 8)
// for rows of 8 or more chunks, chunk ^ ((row / 2) % 4) for the 4-chunk
// rows of the BK = 32 P and dS tiles. tests/test_torch_fwd_design.py
// emulates every fragment and ldmatrix of this kernel in numpy and checks
// the banks. Shared memory per CTA: 2 (2 BK D + 2 BQ D + 2 BQ BK) + 4 (2 BQ +
// BK) bytes: 49,920 (D = 64), 82,688 (D = 128), 82,560 (D = 192), 107,136
// (D = 256).
//
// Fully masked rows. As in the f32 kernel (csrc/flash_attention_bwd.cu):
// s and lse both round to the bias there, so P = exp(s - lse) is 1 for every
// key, as the TPU kernels and the plain twin compute it.
//
// What bounds it on the card (computed from shapes). At the training shape
// (B, H, S, D) = (512, 6, 64, 128), no dbias, the pass reads q, k, v, O and
// dO and writes dq, dk and dv once: 8 bf16 tensors of 50.3 MB, plus lse
// (0.8 MB): 403 MB, 0.120 ms at 3.35 TB/s. Its 5 products of 2 S^2 D are
// 16.1 GFLOP, 0.016 ms at 989 TFLOP/s of dense bf16. So the bytes set the
// bound, and the design reads each input once per CTA and keeps S, dP and
// the accumulators on chip. A simple design: one stage of Q and dO in
// flight beside dQ, mma.sync rather than wgmma. chip_smoke.py prints the
// ptxas report of every build and PERF.md keeps the times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 64;  // query rows per tile

template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 64 : 32;  // keys per CTA
  static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
  // S, dP (BQ x BK): 4 row groups x 2 key halves
  static constexpr int NT_A = BK / 16;  // 8-key tiles per warp
  // dK, dV (BK x D): BK / 16 key groups x NPART column parts
  static constexpr int KG = BK / 16;
  static constexpr int NPART = kWarps / KG;
  static constexpr int NT_C = D / (8 * NPART);  // 8-column tiles per warp
  // dQ (BQ x D): 4 row groups x 2 column halves, 32 columns at a time
  static constexpr int NCH = D / 64;
  static constexpr size_t SMEM = 2 * (2 * BK * D + 2 * kBlockQ * D + 2 * kBlockQ * BK) +
                                 4 * (2 * kBlockQ + BK);
};

// Element offset of (r, c) in a swizzled (rows, W) bf16 tile: 16-byte chunk
// c / 8 of row r is stored at chunk (c / 8) ^ (r % 8) when a row has 8 or
// more chunks (W >= 64), at (c / 8) ^ ((r / 2) % 4) when it has 4 (W = 32).
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kShift = W >= 64 ? 0 : 1, kMask = W >= 64 ? 7 : 3;
  return r * W + (((c >> 3) ^ ((r >> kShift) & kMask)) << 3) + (c & 7);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));  // src-size 0 fills the 16 bytes with zeros
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and r[i] receives this lane's two elements of it: (g, 2t..2t+1),
// or with .trans (2t..2t+1, g), the lower index in the low half.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += A B, A (16 x 16) and B (16 x 8) bf16, c f32. Fragments (g = lane / 4,
// t = lane % 4), two bf16 a register, the lower column in the low half:
// a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
// b0 (2t..2t+1, g), b1 (2t + 8.., g); c0, c1 (g, 2t + {0, 1}), c2, c3 (g + 8, ..).
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16x2 of (lo, hi), each rounded to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// f32 dot product of two runs of 8 bf16
__device__ __forceinline__ float dot8(const uint4& x, const uint4& y) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(a[i]), w = __bfloat1622float2(b[i]);
    s += u.x * w.x + u.y * w.y;
  }
  return s;
}

// rows [r0, r0 + rows) of a (seq, D) bf16 matrix into a swizzled shared tile;
// rows past seq are zero-filled
template <int D>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int r0, int rows, int seq,
                                      int tid) {
  constexpr int C8 = D / 8;
  for (int i = tid; i < rows * C8; i += kThreads) {
    const int r = i / C8, c = (i % C8) * 8;
    const bool ok = r0 + r < seq;
    cp_async16(dst + swz<D>(r, c), src + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::MIN_BLOCKS)
flash_bwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ bias,
                      const bf16* __restrict__ out, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, bf16* __restrict__ dq,
                      float* __restrict__ dq_part, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ dbias_part, int heads,
                      int seq, float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, BQ = kBlockQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // (BK, D)
  bf16* Vs = Ks + BK * D;                        // (BK, D)
  bf16* Qs = Vs + BK * D;                        // (BQ, D)
  bf16* dOs = Qs + BQ * D;                       // (BQ, D)
  bf16* Ps = dOs + BQ * D;                       // (BQ, BK): bf16(P)
  bf16* dSs = Ps + BQ * BK;                      // (BQ, BK): bf16(dS)
  float* Ls = reinterpret_cast<float*>(dSs + BQ * BK);
  float* Dl = Ls + BQ;
  float* Bk = Dl + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;  // ldmatrix: row of matrix lmat this lane addresses
  const size_t base = (size_t)bh * seq * D;
  const bool with_dbias = dbias_part != nullptr;

  stage<D>(Ks, k + base, k0, BK, seq, tid);
  stage<D>(Vs, v + base, k0, BK, seq, tid);
  stage<D>(Qs, q + base, 0, BQ, seq, tid);
  stage<D>(dOs, dout + base, 0, BQ, seq, tid);
  cp_async_commit();
  if (tid < BK) {
    Bk[tid] = k0 + tid < seq ? __bfloat162float(bias[(size_t)(bh / heads) * seq + k0 + tid]) : 0.f;
  }

  // warp roles: S, dP and dQ rows (a_m0); S, dP keys (a_n0); dK, dV keys
  // (c_m0) and columns (c_n0); dQ columns (e_n0)
  const int a_m0 = (warp >> 1) * 16;
  const int a_n0 = (warp & 1) * (BK / 2);
  const int c_m0 = (warp % C::KG) * 16;
  const int c_n0 = (warp / C::KG) * (D / C::NPART);
  const int e_n0 = (warp & 1) * (D / 2);

  float dk_acc[C::NT_C][4], dv_acc[C::NT_C][4];
#pragma unroll
  for (int n = 0; n < C::NT_C; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
  // dbias of keys a_n0 + 8n + 2t + j over this warp's rows of every tile
  float db[C::NT_A][2];
#pragma unroll
  for (int n = 0; n < C::NT_A; ++n) db[n][0] = db[n][1] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += BQ) {
    // delta and lse of the tile's rows: 8 rows a warp, 4 lanes a row,
    // every load in flight at once; overlaps the copies
    {
      constexpr int RW = BQ / kWarps, LR = 32 / RW;
      const int r = warp * RW + lane / LR;
      const int row = q0 + r;
      float s = 0.f;
      if (row < seq) {
        const uint4* o8 = reinterpret_cast<const uint4*>(out + base + (size_t)row * D);
        const uint4* d8 = reinterpret_cast<const uint4*>(dout + base + (size_t)row * D);
#pragma unroll
        for (int j = 0; j < D / 8 / LR; ++j) s += dot8(o8[lane % LR + LR * j], d8[lane % LR + LR * j]);
      }
#pragma unroll
      for (int off = LR / 2; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane % LR == 0) {
        Dl[r] = s;
        Ls[r] = row < seq ? lse[(size_t)bh * seq + row] : 0.f;
      }
    }
    cp_async_wait_all();
    __syncthreads();  // Q, dO (K, V, bias the first time), lse and delta in place

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x BK / 2 keys. The A
    // matrices: rows a_m0 + 8 (i & 1), depths kk + 8 (i >> 1); the B ones:
    // keys a_n0 + 16 np + 8 (i >> 1), depths kk + 8 (i & 1)
    float sacc[C::NT_A][4], pacc[C::NT_A][4];
#pragma unroll
    for (int n = 0; n < C::NT_A; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[n][i] = pacc[n][i] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4], b[4];
      const int ar = a_m0 + lrow + 8 * (lmat & 1), ac = kk + 8 * (lmat >> 1);
      ldsm_x4(a, Qs + swz<D>(ar, ac));
#pragma unroll
      for (int np = 0; np < C::NT_A / 2; ++np) {
        ldsm_x4(b, Ks + swz<D>(a_n0 + 16 * np + lrow + 8 * (lmat >> 1), kk + 8 * (lmat & 1)));
        mma(sacc[2 * np], a, b);
        mma(sacc[2 * np + 1], a, b + 2);
      }
      ldsm_x4(a, dOs + swz<D>(ar, ac));
#pragma unroll
      for (int np = 0; np < C::NT_A / 2; ++np) {
        ldsm_x4(b, Vs + swz<D>(a_n0 + 16 * np + lrow + 8 * (lmat >> 1), kk + 8 * (lmat & 1)));
        mma(pacc[2 * np], a, b);
        mma(pacc[2 * np + 1], a, b + 2);
      }
    }

    // P = exp(s * scale + bias - lse), dS = P (dP - delta) in f32, zero off
    // the ragged edges (rows or keys past S); bf16 copies to shared memory;
    // the dbias sums of the f32 dS over the 16 rows of the fragment
#pragma unroll
    for (int n = 0; n < C::NT_A; ++n) {
      const int c = a_n0 + 8 * n + 2 * t;
      float col[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = a_m0 + g + 8 * h;
        const bool row_ok = q0 + r < seq;
        const float lr = Ls[r], dr = Dl[r];
        float p[2], ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = __fadd_rn(__fmul_rn(sacc[n][2 * h + j], scale), Bk[c + j]);
          p[j] = row_ok && k0 + c + j < seq ? expf(__fsub_rn(x, lr)) : 0.f;
          ds[j] = __fmul_rn(p[j], __fsub_rn(pacc[n][2 * h + j], dr));
          col[j] += ds[j];
        }
        *reinterpret_cast<uint32_t*>(Ps + swz<BK>(r, c)) = pack(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dSs + swz<BK>(r, c)) = pack(ds[0], ds[1]);
      }
      if (with_dbias) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) col[j] += __shfl_xor_sync(0xffffffffu, col[j], off);
          db[n][j] += col[j];
        }
      }
    }
    __syncthreads();  // P, dS of the tile in place

    // dV += P^T dO, dK += dS^T Q: this warp's 16 keys x D / NPART columns.
    // A (P^T, dS^T) by ldmatrix.trans of the query-major tiles: matrices of
    // queries kq + 8 (i >> 1), keys c_m0 + 8 (i & 1); B (dO, Q) transposed:
    // queries kq + 8 (i & 1), columns c_n0 + 16 np + 8 (i >> 1)
#pragma unroll
    for (int kq = 0; kq < BQ; kq += 16) {
      uint32_t pa[4], sa[4];
      const int pr = kq + lrow + 8 * (lmat >> 1), pc = c_m0 + 8 * (lmat & 1);
      ldsm_x4_trans(pa, Ps + swz<BK>(pr, pc));
      ldsm_x4_trans(sa, dSs + swz<BK>(pr, pc));
#pragma unroll
      for (int np = 0; np < C::NT_C / 2; ++np) {
        uint32_t b[4];
        const int br = kq + lrow + 8 * (lmat & 1), bc = c_n0 + 16 * np + 8 * (lmat >> 1);
        ldsm_x4_trans(b, dOs + swz<D>(br, bc));
        mma(dv_acc[2 * np], pa, b);
        mma(dv_acc[2 * np + 1], pa, b + 2);
        ldsm_x4_trans(b, Qs + swz<D>(br, bc));
        mma(dk_acc[2 * np], sa, b);
        mma(dk_acc[2 * np + 1], sa, b + 2);
      }
    }
    __syncthreads();  // Q and dO consumed: the next tile's may land
    if (q0 + BQ < seq) {
      stage<D>(Qs, q + base, q0 + BQ, BQ, seq, tid);
      stage<D>(dOs, dout + base, q0 + BQ, BQ, seq, tid);
      cp_async_commit();
    }

    // dQ = dS K of the tile: this warp's 16 rows x D / 2 columns, 32 at a
    // time. dS's A matrices: rows a_m0 + 8 (i & 1), keys 16 j + 8 (i >> 1);
    // K's B matrices, transposed: keys 16 j + 8 (i & 1), columns
    // e_n0 + 32 ch + 16 np + 8 (i >> 1)
    uint32_t sfrag[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      ldsm_x4(sfrag[j], dSs + swz<BK>(a_m0 + lrow + 8 * (lmat & 1), 16 * j + 8 * (lmat >> 1)));
    }
#pragma unroll
    for (int ch = 0; ch < C::NCH; ++ch) {
      float qacc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) qacc[n][i] = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, Ks + swz<D>(16 * j + lrow + 8 * (lmat & 1),
                                       e_n0 + 32 * ch + 16 * np + 8 * (lmat >> 1)));
          mma(qacc[2 * np], sfrag[j], b);
          mma(qacc[2 * np + 1], sfrag[j], b + 2);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + a_m0 + g + 8 * h;
        if (row >= seq) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const size_t off = base + (size_t)row * D + e_n0 + 32 * ch + 8 * n + 2 * t;
          const float x0 = __fmul_rn(qacc[n][2 * h], scale);
          const float x1 = __fmul_rn(qacc[n][2 * h + 1], scale);
          if (dq_part != nullptr) {
            *reinterpret_cast<float2*>(dq_part + (size_t)blockIdx.y * gridDim.x * seq * D + off) =
                make_float2(x0, x1);
          } else {
            *reinterpret_cast<uint32_t*>(dq + off) = pack(x0, x1);
          }
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + c_m0 + g + 8 * h;
    if (key >= seq) continue;
    const size_t off = base + (size_t)key * D + c_n0 + 2 * t;
#pragma unroll
    for (int n = 0; n < C::NT_C; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
          pack(__fmul_rn(dk_acc[n][2 * h], scale), __fmul_rn(dk_acc[n][2 * h + 1], scale));
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) = pack(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
  if (with_dbias) {
    // the four row groups' sums of each key, added in row-group order
    __syncthreads();  // every warp is past its last read of the P tile
    float* part = reinterpret_cast<float*>(Ps);  // (4, BK)
    if (g == 0) {
#pragma unroll
      for (int n = 0; n < C::NT_A; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) part[(warp >> 1) * BK + a_n0 + 8 * n + 2 * t + j] = db[n][j];
    }
    __syncthreads();
    if (tid < BK && k0 + tid < seq) {
      dbias_part[(size_t)bh * seq + k0 + tid] =
          ((part[tid] + part[BK + tid]) + part[2 * BK + tid]) + part[3 * BK + tid];
    }
  }
}

// The dynamic shared memory of width D, set once per device (an attribute
// of the kernel in that device's context).
template <int D>
cudaError_t set_attributes() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;  // past 64: every launch
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_bwd_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_bf16_kernel<D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  done.fetch_or(bit);
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* bias,
                   const bf16* out, const bf16* dout, const float* lse, bf16* dq,
                   float* dq_part, bf16* dk, bf16* dv, float* dbias_part, int batch,
                   int heads, int seq, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const long long bh = (long long)batch * heads, key_blocks = (seq + C::BK - 1) / C::BK;
  if (bh > 0x7fffffffLL || key_blocks > 65535) return cudaErrorInvalidValue;
  // dq straight (bf16) when one block holds every key, else the f32 slabs
  if ((key_blocks > 1 ? dq_part : reinterpret_cast<float*>(dq)) == nullptr) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = set_attributes<D>();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bh, (unsigned)key_blocks);
  flash_bwd_bf16_kernel<D><<<grid, kThreads, C::SMEM, stream>>>(
      q, k, v, bias, out, dout, lse, key_blocks > 1 ? nullptr : dq,
      key_blocks > 1 ? dq_part : nullptr, dk, dv, dbias_part, heads, seq, scale);
  return cudaGetLastError();
}

}  // namespace

// Keys per CTA for head width `dim` (the number of dQ slabs is
// ceil(S / this)); -1 for a width the kernel does not take.
extern "C" int ufnd_flash_attention_bwd_bf16_block_keys(int dim) {
  switch (dim) {
    case 64: return Cfg<64>::BK;
    case 128: return Cfg<128>::BK;
    case 192: return Cfg<192>::BK;
    case 256: return Cfg<256>::BK;
    default: return -1;
  }
}

// Plain C entry point (loaded with ctypes). q, k, v, out, dout, dk, dv:
// contiguous (B, H, S, D) bf16; bias: contiguous (B, S) bf16; lse: (B, H, S)
// f32; dq: (B, H, S, D) bf16 when S <= block_keys(D), else null and dq_part
// the (ceil(S / block_keys), B, H, S, D) f32 slabs; dbias_part: (B, H, S)
// f32, or null to skip dbias. One launch on `stream`. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int ufnd_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                             const void* bias, const void* out,
                                             const void* dout, const float* lse, void* dq,
                                             float* dq_part, void* dk, void* dv,
                                             float* dbias_part, int batch, int heads,
                                             int seq, int dim, float scale, void* stream) {
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v), *b_ = static_cast<const bf16*>(bias),
             *o_ = static_cast<const bf16*>(out), *do_ = static_cast<const bf16*>(dout);
  bf16 *dq_ = static_cast<bf16*>(dq), *dk_ = static_cast<bf16*>(dk),
       *dv_ = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 64: return launch<64>(q_, k_, v_, b_, o_, do_, lse, dq_, dq_part, dk_, dv_, dbias_part,
                               batch, heads, seq, scale, s);
    case 128: return launch<128>(q_, k_, v_, b_, o_, do_, lse, dq_, dq_part, dk_, dv_,
                                 dbias_part, batch, heads, seq, scale, s);
    case 192: return launch<192>(q_, k_, v_, b_, o_, do_, lse, dq_, dq_part, dk_, dv_,
                                 dbias_part, batch, heads, seq, scale, s);
    case 256: return launch<256>(q_, k_, v_, b_, o_, do_, lse, dq_, dq_part, dk_, dv_,
                                 dbias_part, batch, heads, seq, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
