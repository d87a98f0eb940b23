// Flash-attention forward (K2) for Hopper: f32 in and out, the products on
// the tensor cores at f32 accuracy (3xTF32), the softmax in f32.
//
// Replaces: ultrafnd_git_tpu/kernels/flash_attention.py::_make_fwd_kernel
// (launched by _pallas_forward). Same outputs: out = softmax(q k^T * scale
// + bias) v and the per-row lse = m + log(sum exp(s - m)), with the additive
// key-padding bias of shape (B, 1, 1, S) (0 or -1e9, never -inf), added in
// f32 after the product (s * scale, then + bias, each rounded once, as the
// plain version does). Keys past S in a ragged last tile are excluded
// outright; masked keys keep the -1e9, so a fully masked row gets the
// reference's uniform softmax and lse = -1e9 + log S, never NaN. No float
// atomics: two calls give the same bits.
//
// Design. A CTA of 4 warps takes one batch*head (blockIdx.x) and tile of
// BQ query rows (blockIdx.y) and walks its key tiles of BK keys with the
// online softmax (running row max and sum in f32, O rescaled once per key
// tile). A warp owns 16 query rows: it computes their S = Q K^T for the
// whole key tile and their O += P V for its D / WC output columns (WC = 2
// at D >= 192, where two warps share 16 rows and each computes S itself,
// so that O stays at 64 registers a thread). Both products are
// mma.sync.m16n8k8 TF32 in 3xTF32 (tf32_mma.cuh), the small terms first,
// term by term across the column tiles.
//  * S = Q K^T reads Q and K with the depth index permuted (depths 2t, 2t+1
//    of a thread as one 64-bit LDS), as the backward does.
//  * P never leaves registers. The C fragment of S gives a thread keys 2t
//    and 2t+1 of each 8-key tile; PV's A fragment wants depths t and t+4.
//    With logical depth t <-> key 2t and t+4 <-> key 2t+1, P's accumulators
//    (c0, c2, c1, c3) are PV's A fragment (a0, a1, a2, a3) as they stand.
//    V's B fragment must then read keys 2t and 2t+1: V is staged with its
//    rows permuted inside each group of 8 keys (key 2i -> row i, key 2i+1
//    -> row i+4, vrow below), so the B loads fall on the plain (t, g) /
//    (t+4, g) pattern, which the swizzle keeps free of bank conflicts.
//  * Q, K and V come in by cp.async (16 bytes a thread) into XOR-swizzled
//    tiles, in two copy groups per key tile (Q and K, then V), so S = Q K^T
//    starts while V is still in flight. Loads overlap products across CTAs:
//    one stage of K/V, 96 KB of shared memory at D = 128, two CTAs per SM.
//    Two variants were slower on the H100 at every shape tried (PERF.md
//    keeps their times): a two-stage ring of K/V tiles for S > BK, and
//    persistent CTAs that load the next work item while computing this one
//    (192 KB, one CTA per SM).
//
// Constants (tests/test_torch_fwd_design.py mirrors them): kWarps = 4;
// WC = D <= 128 ? 1 : 2; BQ = 16 * kWarps / WC (64, or 32 at D >= 192);
// BK = D <= 128 ? 64 : 32; vrow; the swizzle, split and fragment layouts
// of tf32_mma.cuh. Shared memory: (BQ + 2 * BK) * D floats.
//
// What bounds it on the card (computed from shapes). At the serving shape
// (256, 6, 64, 128) the call reads q, k, v and bias and writes out and lse:
// 201.8 MB, 0.060 ms at 3.35 TB/s; its two products are 3.2 GFLOP, 0.048 ms
// even at the f32 peak of 67 TFLOP/s. At the training shape (512, 6, 64,
// 128): 403.6 MB, 0.120 ms; 6.4 GFLOP, 0.096 ms. On the tensor cores the
// products are 3 x 6.4 = 19.3 GFLOP of TF32, 0.039 ms at 495 TFLOP/s, so
// the bytes set the bound; the design reads each input once per CTA,
// keeps S and P in registers and overlaps the copies with the products.
// ptxas (-Xptxas -v, sm_90a, the H100 machine's nvcc), no spills at any D:
// D = 64: 230 registers; D = 128: 255 (the cap of two CTAs of 128 threads
// per SM); D = 192: 200; D = 256: 229. Shared memory per CTA: D = 64:
// 49,152 B; D = 128: 98,304 B; D = 192: 73,728 B; D = 256: 98,304 B.
// chip_smoke.py prints the report of every build; PERF.md keeps the times
// (NVIDIA H100 80GB HBM3).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "tf32_mma.cuh"  // swz, cp.async, split, mma, mma3, fragment loads

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int D>
struct Cfg {
  static constexpr int WC = D <= 128 ? 1 : 2;    // warps sharing 16 query rows
  static constexpr int BQ = 16 * kWarps / WC;    // query rows per CTA
  static constexpr int BK = D <= 128 ? 64 : 32;  // keys per tile
  static constexpr int NT_S = BK / 8;            // 8-key tiles of a warp's S
  static constexpr int DW = D / WC;              // output columns per warp
  static constexpr int NT_O = DW / 8;            // 8-column tiles of a warp's O
  static constexpr int CG = 4;                   // O tiles whose B fragments are in flight
  static constexpr size_t SMEM = sizeof(float) * (BQ + 2 * BK) * D;  // Q, K, V tiles
};

// Shared row of key j of a V tile: inside each group of 8 keys, key 2i goes
// to row i and key 2i+1 to row i+4.
__device__ __forceinline__ int vrow(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);
}

// rows [r0, r0 + rows) of a (seq, D) matrix into a swizzled shared tile (V's
// rows permuted by vrow); rows past seq are zero-filled
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int rows, int seq,
                                      int tid, bool permute) {
  constexpr int C4 = D / 4;
  for (int i = tid; i < rows * C4; i += kThreads) {
    const int r = i / C4, c = (i % C4) * 4;
    const bool ok = r0 + r < seq;
    cp_async16(dst + swz(permute ? vrow(r) : r, c, D), src + (size_t)(ok ? r0 + r : 0) * D + c,
               ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int heads, int seq,
                 float scale) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NT_S = C::NT_S, NT_O = C::NT_O, CG = C::CG;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;           // (BQ, D)
  float* Ks = Qs + BQ * D;    // (BK, D)
  float* Vs = Ks + BK * D;    // (BK, D), rows permuted by vrow

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp / C::WC) * 16;      // the warp's query rows in the tile
  const int n0 = (warp % C::WC) * C::DW;   // and its output columns
  const int k_tiles = (seq + BK - 1) / BK;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const size_t base = (size_t)bh * seq * D;
  const float* brow = bias + (size_t)(bh / heads) * seq;

  // cp.async of key tile kt: K (and Q on the first tile) as one group, then
  // V as a second
  auto load_tile = [&](int kt) {
    if (kt == 0) stage<D>(Qs, q + base, q0, BQ, seq, tid, false);
    stage<D>(Ks, k + base, kt * BK, BK, seq, tid, false);
    cp_async_commit();
    stage<D>(Vs, v + base, kt * BK, BK, seq, tid, true);
    cp_async_commit();
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, oacc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  load_tile(0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * BK;
    // this thread's keys of the tile, 8n + 2t + {0, 1}: bias, in flight
    // during the product
    float bk[NT_S][2];
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * n + 2 * t + e;
        bk[n][e] = key < seq ? __ldg(brow + key) : -INFINITY;
      }

    cp_async_wait<1>();
    __syncthreads();  // Q and K of the tile in place

    // S = Q K^T: the warp's 16 rows x BK keys
    float sacc[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t ah[4], al[4], bh_[NT_S][2], bl_[NT_S][2];
      load_a2<D>(Qs, m0, kk, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < NT_S; ++n) load_bt2<D>(Ks, kk, 8 * n, g, t, bh_[n], bl_[n]);
      mma3<NT_S>(sacc, ah, al, bh_, bl_);
    }

    // online softmax on the fragments: rows g (h = 0) and g + 8 (h = 1),
    // each spread over the 4 lanes of a quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float b = bk[n][e & 1];
        const float x = b == -INFINITY ? -INFINITY : __fadd_rn(__fmul_rn(sacc[n][e], scale), b);
        sacc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mx[h] = fmaxf(m[h], mx[h]);    // finite: key k0 < seq is in every tile
      alpha[h] = expf(m[h] - mx[h]);  // 0 on the first tile
      m[h] = mx[h];
    }
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sacc[n][e] - m[e >> 1]);  // 0 past S
        sacc[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
    cp_async_wait<0>();
    __syncthreads();  // V of the tile in place

    // O = alpha O + P V, CG output tiles at a time: the tile's P V goes into
    // a fresh accumulator (a chain of 3 NT_S MMAs, whose f32 sums the tensor
    // cores do not round to nearest) and is added to O in f32, so the error
    // does not grow with the number of key tiles. P's C fragment of 8-key
    // tile kn is the A fragment (depth t = key 2t, depth t + 4 = key 2t + 1),
    // V's rows permuted to match.
#pragma unroll
    for (int n = 0; n < NT_O; n += CG) {
      float pv[CG][4];
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[c][e] = 0.f;
#pragma unroll
      for (int kn = 0; kn < NT_S; ++kn) {
        uint32_t ah[4], al[4], bh_[CG][2], bl_[CG][2];
        split(sacc[kn][0], ah[0], al[0]);
        split(sacc[kn][2], ah[1], al[1]);
        split(sacc[kn][1], ah[2], al[2]);
        split(sacc[kn][3], ah[3], al[3]);
#pragma unroll
        for (int c = 0; c < CG; ++c) load_b<D>(Vs, 8 * kn, n0 + 8 * (n + c), g, t, bh_[c], bl_[c]);
        mma3<CG>(pv, ah, al, bh_, bl_);
      }
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          oacc[n + c][e] = __fadd_rn(__fmul_rn(oacc[n + c][e], alpha[e >> 1]), pv[c][e]);
    }
    if (kt + 1 < k_tiles) {
      __syncthreads();  // the tile's K and V consumed
      load_tile(kt + 1);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + g + 8 * h;
    if (row >= seq) continue;
    float* orow = out + base + (size_t)row * D + n0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(oacc[n][2 * h] / l[h], oacc[n][2 * h + 1] / l[h]);
    }
    if (t == 0 && n0 == 0) lse[(size_t)bh * seq + row] = m[h] + logf(l[h]);
  }
}

// The dynamic shared memory and carveout of width D, set once per device
// (an attribute of the kernel in that device's context).
template <int D>
cudaError_t set_attributes() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;  // past 64: every launch
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  done.fetch_or(bit);
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   float* out, float* lse, int batch, int heads, int seq, float scale,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  const long long bh = (long long)batch * heads, q_tiles = (seq + C::BQ - 1) / C::BQ;
  if (bh > 0x7fffffffLL || q_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)bh, (unsigned)q_tiles);
  const cudaError_t err = set_attributes<D>();
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D><<<grid, kThreads, C::SMEM, stream>>>(q, k, v, bias, out, lse,
                                                           heads, seq, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v, out: contiguous
// (B, H, S, D) f32; bias: contiguous (B, S) f32; lse: (B, H, S) f32.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int ufnd_flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                                            const float* bias, float* out, float* lse,
                                            int batch, int heads, int seq, int dim,
                                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 64: return launch<64>(q, k, v, bias, out, lse, batch, heads, seq, scale, s);
    case 128: return launch<128>(q, k, v, bias, out, lse, batch, heads, seq, scale, s);
    case 192: return launch<192>(q, k, v, bias, out, lse, batch, heads, seq, scale, s);
    case 256: return launch<256>(q, k, v, bias, out, lse, batch, heads, seq, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
