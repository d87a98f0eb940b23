// Flash-attention backward for Hopper: dQ, dK, dV and the dbias partials in
// one pass, on the tensor cores at f32 accuracy (3xTF32), f32 in and out.
//
// Replaces: ultrafnd_git_tpu/kernels/flash_attention.py::_make_bwd_dq_kernel
// (K3) and ::_make_bwd_dkv_kernel (K4), both launched by _pallas_backward,
// with one kernel and one launch per backward call. Same outputs: with
// s = q k^T * scale + bias, P = exp(s - lse) recomputed in f32,
// delta = rowsum(dO * O) and dS = P * (dO V^T - delta):
//   dQ = dS K * scale, dK = dS^T Q * scale, dV = P^T dO,
//   dbias partial = sum of dS over every query row, per (batch*head, key).
// The wrapper (kernels/flash_attention.py::flash_attention_bwd) adds one to
// `bwd_launches` per call and sums the dbias partials over heads (and the
// dQ partials over key blocks when S > BK) in a fixed order. No float
// atomics: two calls give the same bits.
//
// Design. One CTA per (batch*head, block of BK keys): BK = 64 for D <= 128,
// 32 for D = 192 and 256, 8 warps. At the training path's S = 64 that is
// one CTA per (b, h) holding every key. The CTA stages its K and V once in
// shared memory (cp.async, 16 bytes a thread) and walks the query tiles
// (BQ = 32) of Q and dO. Per tile:
//  * delta = rowsum(dO * O) of the tile's rows, from device memory (no
//    torch reduction outside the kernel; 8 lanes a row, so every load of
//    a warp is in flight at once), and lse, into shared memory;
//  * S = Q K^T and dP = dO V^T, each computed once (the two scalar kernels
//    this replaces computed both twice: 5 products of S^2 D, not 7);
//  * P and dS into shared memory, and the per-key sum of dS (dbias) in a
//    register of one thread per key, in row order;
//  * dV += P^T dO and dK += dS^T Q, accumulated in registers across tiles;
//  * the next tile's Q and dO start loading (cp.async) while
//  * dQ = dS K is computed and written: straight into dq when the CTA holds
//    every key (S <= BK), else into a (ceil(S/BK), B*H, S, D) partial slab.
// Products: mma.sync.m16n8k8 TF32 with 3xTF32 splitting. Each operand is
// split as x = hi + lo, hi = x rounded to TF32 (half an ulp added, low 13
// bits cleared: two integer ops, cheaper than cvt.rna and the same but for
// ties), lo = x - hi, and a*b ~ lo_a*hi_b + hi_a*lo_b + hi_a*hi_b,
// accumulated in f32: about f32 accuracy (one TF32 pass keeps about three
// decimal digits). The three terms go term by term across a warp's column
// tiles, so that several accumulator chains are in flight. Fragments load
// with plain LDS (ldmatrix's transpose takes only 16-bit elements); in
// S = Q K^T and dP = dO V^T both operands permute the depth index alike,
// so each thread's two depths are adjacent and load as one 64-bit LDS.
// Every shared tile is XOR-swizzled in 16-byte chunks (chunk ^ h(row % 8),
// h(r) = ((r & 3) << 1) | (r >> 2 & 1)), so the row-order fragment loads
// (8 rows x 4 columns, 32- or 64-bit) and the transposed ones (4 rows x 8
// columns) all hit distinct banks. Shared memory per CTA:
// 66,048 B (D = 64), 115,200 B (D = 128, two CTAs per SM), 106,880 B
// (D = 192, two per SM), 139,648 B (D = 256, one per SM).
//
// Fully masked rows. The bias is -1e9 and the ulp of 1e9 in f32 is 64, so
// on a row whose keys are all masked every s rounds to exactly -1e9, and so
// does lse. P = exp(s - lse) is then 1 for every key, not 1/S as autograd
// of a softmax gives. The TPU kernels compute this, and so does this kernel
// and its plain version, attention_bwd_reference. The trainer never sends
// such a row a nonzero dO: pooling multiplies by the mask.
//
// What bounds it on the card (computed from shapes). At the training shape
// (B, H, S, D) = (512, 6, 64, 128), delta included and no dbias, the pass
// reads q, k, v, O and dO and writes dq, dk and dv once: 8 tensors of
// 100.7 MB, 806 MB, 0.241 ms at 3.35 TB/s. Its 5 products of S^2 D are
// 16.1 GFLOP, 0.240 ms at the f32 peak of 67 TFLOP/s, so the bound is
// 0.241 ms, set by the bytes. (The 0.33 ms this file used to call a floor
// counted the old pair's own redundant work, 7 products and 11 tensor
// passes.) 3xTF32 is 48 GFLOP of TF32, about 0.1 ms at the TF32 peak, so
// on the tensor cores the bound is still the bytes; PERF.md says how far
// this kernel is from it and what holds it there.
// ptxas (-Xptxas -v, sm_90a, the H100 machine's nvcc): D = 64: 128
// registers, no spills; D = 128: 128 registers (the cap of two CTAs per SM),
// 44 bytes of spill stores, 68 of loads; D = 192: 128 registers, 52 and 80
// bytes; D = 256: 186 registers, no spills. chip_smoke.py prints the report
// of every build. Measured at the training shape on an H100 80GB HBM3 at
// 700 W: see PERF.md.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // swz, cp.async, split, mma, mma3, fragment loads

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 32;  // query rows per tile

template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 64 : 32;    // keys per CTA
  static constexpr int MIN_BLOCKS = D <= 192 ? 2 : 1;
  // S, dP (BQ x BK): 2 query halves x 4 key groups of BK / 4 keys
  static constexpr int NT_A = BK / 32;              // 8-key tiles per warp
  // dK, dV (BK x D): BK / 16 key groups x NPART column parts
  static constexpr int KG = BK / 16;
  static constexpr int NPART = kWarps / KG;
  static constexpr int NT_C = D / (8 * NPART);      // 8-column tiles per warp
  static constexpr int CG = NT_C % 4 == 0 ? 4 : 2;  // of which in flight at once
  // dQ (BQ x D): 2 query halves x 4 column parts
  static constexpr int NT_E = D / 32;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * BK * D + 2 * kBlockQ * D + 2 * kBlockQ * BK + 2 * kBlockQ + BK);
};

// rows [r0, r0 + rows) of a (seq, W) matrix into a swizzled shared tile;
// rows past seq are zero-filled
template <int W>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int rows, int seq,
                                      int tid) {
  constexpr int C4 = W / 4;
  for (int i = tid; i < rows * C4; i += kThreads) {
    const int r = i / C4, c = (i % C4) * 4;
    const bool ok = r0 + r < seq;
    cp_async16(dst + swz(r, c, W), src + (size_t)(ok ? r0 + r : 0) * W + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::MIN_BLOCKS)
flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ out, const float* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ dq,
                 float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dbias_part, int heads, int seq, float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, BQ = kBlockQ;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * D;
  float* Qs = Vs + BK * D;
  float* dOs = Qs + BQ * D;
  float* Ps = dOs + BQ * D;
  float* dSs = Ps + BQ * BK;
  float* Ls = dSs + BQ * BK;
  float* Dl = Ls + BQ;
  float* Bk = Dl + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * seq * D;

  stage<D>(Ks, k + base, k0, BK, seq, tid);
  stage<D>(Vs, v + base, k0, BK, seq, tid);
  stage<D>(Qs, q + base, 0, BQ, seq, tid);
  stage<D>(dOs, dout + base, 0, BQ, seq, tid);
  cp_async_commit();
  if (tid < BK) Bk[tid] = k0 + tid < seq ? bias[(size_t)(bh / heads) * seq + k0 + tid] : 0.f;

  // warp roles: S, dP and dQ rows (a_m0); S, dP keys (a_n0); dK, dV keys
  // (c_m0) and columns (c_n0); dQ columns (e_n0)
  const int a_m0 = (warp / 4) * 16;
  const int a_n0 = (warp % 4) * (BK / 4);
  const int c_m0 = (warp % C::KG) * 16;
  const int c_n0 = (warp / C::KG) * (D / C::NPART);
  const int e_n0 = (warp % 4) * (D / 4);
  // dQ straight into dq when one CTA holds every key, else this key block's slab
  float* dq_out = dq + (size_t)blockIdx.y * gridDim.x * seq * D + base;

  float dk_acc[C::NT_C][4], dv_acc[C::NT_C][4];
#pragma unroll
  for (int n = 0; n < C::NT_C; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
  float db = 0.f;  // dbias of key k0 + tid (tid < BK), summed in row order

  for (int q0 = 0; q0 < seq; q0 += BQ) {
    // delta and lse of the tile's rows: 4 rows a warp, 8 lanes a row, every
    // load in flight at once; overlaps the copies
    {
      constexpr int RW = BQ / kWarps, LR = 32 / RW;
      const int r = warp * RW + lane / LR;
      const int row = q0 + r;
      float s = 0.f;
      if (row < seq) {
        const float4* o4 = reinterpret_cast<const float4*>(out + base + (size_t)row * D);
        const float4* d4 = reinterpret_cast<const float4*>(dout + base + (size_t)row * D);
#pragma unroll
        for (int j = 0; j < D / 4 / LR; ++j) {
          const float4 a = o4[lane % LR + LR * j], b = d4[lane % LR + LR * j];
          s += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
        }
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

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x BK / 4 keys
    float sacc[C::NT_A][4], pacc[C::NT_A][4];
#pragma unroll
    for (int n = 0; n < C::NT_A; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[n][i] = pacc[n][i] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t ah[4], al[4], bh_[C::NT_A][2], bl_[C::NT_A][2];
      load_a2<D>(Qs, a_m0, kk, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < C::NT_A; ++n) load_bt2<D>(Ks, kk, a_n0 + 8 * n, g, t, bh_[n], bl_[n]);
      mma3<C::NT_A>(sacc, ah, al, bh_, bl_);
      load_a2<D>(dOs, a_m0, kk, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < C::NT_A; ++n) load_bt2<D>(Vs, kk, a_n0 + 8 * n, g, t, bh_[n], bl_[n]);
      mma3<C::NT_A>(pacc, ah, al, bh_, bl_);
    }

    // P = exp(s * scale + bias - lse), dS = P (dP - delta); zero off the
    // ragged edges (rows or keys past S)
#pragma unroll
    for (int n = 0; n < C::NT_A; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = a_m0 + g + 8 * h;
        const int c = a_n0 + 8 * n + 2 * t;
        const bool row_ok = q0 + r < seq;
        const float lr = Ls[r], dr = Dl[r];
        float p[2], ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = __fadd_rn(__fmul_rn(sacc[n][2 * h + j], scale), Bk[c + j]);
          p[j] = row_ok && k0 + c + j < seq ? expf(__fsub_rn(x, lr)) : 0.f;
          ds[j] = p[j] * (pacc[n][2 * h + j] - dr);
        }
        *reinterpret_cast<float2*>(Ps + swz(r, c, BK)) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(dSs + swz(r, c, BK)) = make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();  // P, dS of the tile in place

    if (dbias_part != nullptr && tid < BK) {
      for (int r = 0; r < BQ; ++r) db += dSs[swz(r, tid, BK)];
    }

    // dV += P^T dO, dK += dS^T Q: this warp's 16 keys x D / NPART columns
#pragma unroll
    for (int kq = 0; kq < BQ; kq += 8) {
      uint32_t ph[4], pl[4], sh[4], sl[4], bh_[C::CG][2], bl_[C::CG][2];
      load_at<BK>(Ps, c_m0, kq, g, t, ph, pl);
      load_at<BK>(dSs, c_m0, kq, g, t, sh, sl);
#pragma unroll
      for (int n = 0; n < C::NT_C; n += C::CG) {
#pragma unroll
        for (int j = 0; j < C::CG; ++j) load_b<D>(dOs, kq, c_n0 + 8 * (n + j), g, t, bh_[j], bl_[j]);
        mma3<C::CG>(&dv_acc[n], ph, pl, bh_, bl_);
#pragma unroll
        for (int j = 0; j < C::CG; ++j) load_b<D>(Qs, kq, c_n0 + 8 * (n + j), g, t, bh_[j], bl_[j]);
        mma3<C::CG>(&dk_acc[n], sh, sl, bh_, bl_);
      }
    }
    __syncthreads();  // Q and dO consumed: the next tile's may land
    if (q0 + BQ < seq) {
      stage<D>(Qs, q + base, q0 + BQ, BQ, seq, tid);
      stage<D>(dOs, dout + base, q0 + BQ, BQ, seq, tid);
      cp_async_commit();
    }

    // dQ = dS K of the tile: this warp's 16 rows x D / 4 columns
    float qacc[C::NT_E][4];
#pragma unroll
    for (int n = 0; n < C::NT_E; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) qacc[n][i] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[4], al[4], bh_[C::NT_E][2], bl_[C::NT_E][2];
      load_a<BK>(dSs, a_m0, kk, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < C::NT_E; ++n) load_b<D>(Ks, kk, e_n0 + 8 * n, g, t, bh_[n], bl_[n]);
      mma3<C::NT_E>(qacc, ah, al, bh_, bl_);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + a_m0 + g + 8 * h;
      if (row >= seq) continue;
#pragma unroll
      for (int n = 0; n < C::NT_E; ++n) {
        *reinterpret_cast<float2*>(dq_out + (size_t)row * D + e_n0 + 8 * n + 2 * t) =
            make_float2(qacc[n][2 * h] * scale, qacc[n][2 * h + 1] * scale);
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
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(dk_acc[n][2 * h] * scale, dk_acc[n][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
  if (dbias_part != nullptr && tid < BK && k0 + tid < seq) {
    dbias_part[(size_t)bh * seq + k0 + tid] = db;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   const float* out, const float* dout, const float* lse, float* dq,
                   float* dk, float* dv, float* dbias_part, int batch, int heads, int seq,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_kernel<D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  constexpr int bk = Cfg<D>::BK;
  const dim3 grid(batch * heads, (seq + bk - 1) / bk);
  flash_bwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, out, dout, lse, dq, dk, dv, dbias_part, heads, seq, scale);
  return cudaGetLastError();
}

}  // namespace

// Keys per CTA for head width `dim` (the number of dQ partial slabs is
// ceil(S / this)); -1 for a width the kernel does not take.
extern "C" int ufnd_flash_attention_bwd_block_keys(int dim) {
  switch (dim) {
    case 64: return Cfg<64>::BK;
    case 128: return Cfg<128>::BK;
    case 192: return Cfg<192>::BK;
    case 256: return Cfg<256>::BK;
    default: return -1;
  }
}

// Plain C entry point (loaded with ctypes). q, k, v, out, dout, dk, dv:
// contiguous (B, H, S, D) f32; bias: contiguous (B, S) f32; lse: (B, H, S)
// f32; dq: (B, H, S, D) f32 when S <= block_keys(D), else the
// (ceil(S / block_keys), B, H, S, D) partial slabs; dbias_part: (B, H, S)
// f32, or null to skip dbias. One launch on `stream`. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int ufnd_flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                            const float* bias, const float* out,
                                            const float* dout, const float* lse, float* dq,
                                            float* dk, float* dv, float* dbias_part,
                                            int batch, int heads, int seq, int dim,
                                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 64: return launch<64>(q, k, v, bias, out, dout, lse, dq, dk, dv, dbias_part,
                               batch, heads, seq, scale, s);
    case 128: return launch<128>(q, k, v, bias, out, dout, lse, dq, dk, dv, dbias_part,
                                 batch, heads, seq, scale, s);
    case 192: return launch<192>(q, k, v, bias, out, dout, lse, dq, dk, dv, dbias_part,
                                 batch, heads, seq, scale, s);
    case 256: return launch<256>(q, k, v, bias, out, dout, lse, dq, dk, dv, dbias_part,
                                 batch, heads, seq, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
