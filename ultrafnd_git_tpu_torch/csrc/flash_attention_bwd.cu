// Flash-attention backward (K3 dQ, K4 dK/dV) for Hopper, f32 in / f32 accumulate.
//
// Replaces: ultrafnd_git_tpu/kernels/flash_attention.py::_make_bwd_dq_kernel
// (K3) and ::_make_bwd_dkv_kernel (K4), both launched by _pallas_backward.
// Same outputs: with P = exp(s - lse), s = q k^T * scale + bias, the per-row
// delta = rowsum(dO * O) (computed by the wrapper, as the TPU path computes
// it outside its kernels) and dS = P * (dO V^T - delta):
//   dQ = dS K * scale, dK = dS^T Q * scale, dV = P^T dO,
//   dbias partials = sum of dS over the CTA's query rows, per key.
// The wrapper sums the dbias partials over heads and query tiles in a fixed
// order (no float atomics), so dbias does not depend on the launch order.
// The wrapper (kernels/flash_attention.py::flash_attention_bwd) adds one to
// its `bwd_launches` counter per call, which launches K3 and K4 once each.
//
// Design. The TPU kernels hold the whole K, V (K3) or Q, dO (K4) of one
// (batch, head) in VMEM. Here both keep the split of the TPU kernels but
// tile the other side through shared memory, as K2 does:
//  * K3: one CTA per (batch*head, 64-query tile), 8 warps of 8 query rows;
//    Q and dO of the tile stay in shared memory, K and V stream in 32-key
//    tiles (lane j owns key j for the score and dP dot products, then
//    column group {lane + 32c} of the dQ accumulator).
//  * K4: one CTA per (batch*head, key tile), 8 warps of R key rows (R = 8
//    for D <= 128, 4 for D = 192, 256, where two (R, D) accumulators, dK and
//    dV, would not fit the registers at R = 8); Q, dO, lse and delta stream
//    in 32-query tiles (lane i owns query i for the transposed scores).
// Keys and queries past S (the ragged last tile) are excluded outright.
//
// Fully masked rows. The bias is -1e9 and the ulp of 1e9 in f32 is 64, so
// on a row whose keys are all masked every score s rounds to exactly -1e9,
// and so does lse = -1e9 + log(S). P = exp(s - lse) is therefore 1 for
// every key, not 1/S as autograd of a softmax gives. This is what the TPU
// kernels compute (the JAX backward gives dV on such a row at S times the
// autograd value) and this kernel does the same; the plain version,
// attention_bwd_reference, recomputes P the same way. The trainer never
// sends such a row a nonzero dO: pooling multiplies by the mask.
//
// What bounds it on the card (computed from shapes). At the training shape
// (B, H, S, D) = (512, 6, 64, 128) the backward needs 3 products of
// S^2 D per (b, h), 6 * S^2 * D * B * H = 9.7 GFLOP; this pair recomputes
// the scores and dP in both kernels, 7 products or 22.5 GFLOP. Each kernel
// reads q, k, v and dO once (S = 64 is one tile) and writes its gradients:
// 11 tensors of 100.7 MB, 1.1 GB. That is about 20 flop per byte, at the
// ridge of the f32 CUDA cores (67 TFLOP/s over 3.35 TB/s) and far below
// that of the tensor cores: the floor is about 0.33 ms either way. Like K2,
// this first version runs scalar FMAs on the CUDA cores fed from shared
// memory, and those inner loops bound it; wgmma on TMA-staged tiles and
// bf16 inputs are the later levers.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;           // streamed keys (K3) / queries (K4): one per lane
constexpr int kBlockQ = 64;         // K3 query rows per CTA
constexpr int kRowsQ = kBlockQ / kWarps;  // 8

template <int D>
struct DkvRows {  // K4 key rows per warp
  static constexpr int value = D <= 128 ? 8 : 4;
};

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qs, dOs [BQ][D] + Ks, Vs [32][D+1] + dS [warps][8][32] + dbias [warps][32]
  return sizeof(float) * (2 * kBlockQ * D + 2 * kTile * (D + 1) +
                          kWarps * kRowsQ * kTile + kWarps * kTile);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // Ks, Vs [BK][D] + Qs, dOs [32][D+1] + P, dS [warps][R][32] + lse, delta [32]
  constexpr int bk = kWarps * DkvRows<D>::value;
  return sizeof(float) * (2 * bk * D + 2 * kTile * (D + 1) +
                          2 * kWarps * DkvRows<D>::value * kTile + 2 * kTile);
}

// rows [r0, r0 + rows) of a (seq, D) matrix into shared memory with row
// pitch `pitch`; rows past seq are zero-filled
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* src,
                                          int r0, int rows, int seq, int tid) {
  constexpr int D4 = D / 4;
  for (int i = tid; i < rows * D4; i += kThreads) {
    const int r = i / D4, c = (i % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < seq) x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + c);
    float* d = dst + r * pitch + c;
    if (pitch % 4 == 0) {
      *reinterpret_cast<float4*>(d) = x;
    } else {
      d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
    }
  }
}

// K3: dQ and the dbias partials of one (batch*head, 64-query tile)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    float* __restrict__ dbias_part, int heads, int seq, float scale) {
  constexpr int NC = D / 32;
  constexpr int R = kRowsQ;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBlockQ * D;
  float* Ks = dOs + kBlockQ * D;
  float* Vs = Ks + kTile * (D + 1);
  float* DSs = Vs + kTile * (D + 1);
  float* Bs = DSs + kWarps * R * kTile;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t base = (size_t)bh * seq * D;
  const float* brow = bias + (size_t)(bh / heads) * seq;

  load_rows<D>(Qs, D, q + base, q0, kBlockQ, seq, tid);
  load_rows<D>(dOs, D, dout + base, q0, kBlockQ, seq, tid);

  float lse_r[R], delta_r[R], acc[R][NC];
  bool row_ok[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + warp * R + r;
    row_ok[r] = row < seq;
    lse_r[r] = row_ok[r] ? lse[(size_t)bh * seq + row] : 0.f;
    delta_r[r] = row_ok[r] ? delta[(size_t)bh * seq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  const float* Qw = Qs + warp * R * D;
  const float* dOw = dOs + warp * R * D;
  float* DSw = DSs + warp * R * kTile;

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // previous tile consumed (and Qs, dOs written, first time)
    load_rows<D>(Ks, D + 1, k + base, k0, kTile, seq, tid);
    load_rows<D>(Vs, D + 1, v + base, k0, kTile, seq, tid);
    __syncthreads();

    // scores and dP of this lane's key against the warp's 8 query rows
    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
    const float* vr = Vs + lane * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = fmaf(Qw[r * D + d], kd, s[r]);
        dp[r] = fmaf(dOw[r * D + d], vd, dp[r]);
      }
    }
    const bool valid = k0 + lane < seq;
    const float bj = valid ? brow[k0 + lane] : 0.f;
    float bsum = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = (valid && row_ok[r]) ? expf((s[r] * scale + bj) - lse_r[r]) : 0.f;
      const float ds = p * (dp[r] - delta_r[r]);
      DSw[r * kTile + lane] = ds;
      bsum += ds;
    }
    if (dbias_part != nullptr) Bs[warp * kTile + lane] = bsum;
    __syncwarp();

    const int kn = min(kTile, seq - k0);
    for (int j = 0; j < kn; ++j) {
      float kj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kj[c] = Ks[j * (D + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ds = DSw[r * kTile + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(ds, kj[c], acc[r][c]);
      }
    }
    if (dbias_part != nullptr) {
      __syncthreads();  // every warp's row sums are in Bs
      if (tid < kTile && k0 + tid < seq) {
        float t = 0.f;
        for (int w = 0; w < kWarps; ++w) t += Bs[w * kTile + tid];  // fixed order
        dbias_part[((size_t)bh * gridDim.y + blockIdx.y) * seq + k0 + tid] = t;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!row_ok[r]) continue;
    float* row = dq + base + (size_t)(q0 + warp * R + r) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[lane + 32 * c] = acc[r][c] * scale;
  }
}

// K4: dK and dV of one (batch*head, key tile)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int seq, float scale) {
  constexpr int NC = D / 32;
  constexpr int R = DkvRows<D>::value;
  constexpr int BK = kWarps * R;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * D;
  float* Qs = Vs + BK * D;
  float* dOs = Qs + kTile * (D + 1);
  float* Ps = dOs + kTile * (D + 1);
  float* DSs = Ps + kWarps * R * kTile;
  float* Ls = DSs + kWarps * R * kTile;
  float* Dl = Ls + kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t base = (size_t)bh * seq * D;
  const float* brow = bias + (size_t)(bh / heads) * seq;

  load_rows<D>(Ks, D, k + base, k0, BK, seq, tid);
  load_rows<D>(Vs, D, v + base, k0, BK, seq, tid);

  float bk[R], acc_dk[R][NC], acc_dv[R][NC];
  bool key_ok[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = k0 + warp * R + r;
    key_ok[r] = key < seq;
    bk[r] = key_ok[r] ? brow[key] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;
  }
  const float* Kw = Ks + warp * R * D;
  const float* Vw = Vs + warp * R * D;
  float* Pw = Ps + warp * R * kTile;
  float* DSw = DSs + warp * R * kTile;

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();  // previous tile consumed (and Ks, Vs written, first time)
    load_rows<D>(Qs, D + 1, q + base, q0, kTile, seq, tid);
    load_rows<D>(dOs, D + 1, dout + base, q0, kTile, seq, tid);
    if (tid < kTile) {
      const bool ok = q0 + tid < seq;
      Ls[tid] = ok ? lse[(size_t)bh * seq + q0 + tid] : 0.f;
      Dl[tid] = ok ? delta[(size_t)bh * seq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // transposed scores and dP^T of the warp's R keys against this lane's query
    float st[R], dpt[R];
#pragma unroll
    for (int r = 0; r < R; ++r) st[r] = dpt[r] = 0.f;
    const float* qr = Qs + lane * (D + 1);
    const float* dor = dOs + lane * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], dod = dor[d];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        st[r] = fmaf(Kw[r * D + d], qd, st[r]);
        dpt[r] = fmaf(Vw[r * D + d], dod, dpt[r]);
      }
    }
    const bool qvalid = q0 + lane < seq;
    const float lse_i = Ls[lane], delta_i = Dl[lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = (qvalid && key_ok[r]) ? expf((st[r] * scale + bk[r]) - lse_i) : 0.f;
      Pw[r * kTile + lane] = p;
      DSw[r * kTile + lane] = p * (dpt[r] - delta_i);
    }
    __syncwarp();

    const int qn = min(kTile, seq - q0);
    for (int i = 0; i < qn; ++i) {
      float qi[NC], doi[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        qi[c] = Qs[i * (D + 1) + lane + 32 * c];
        doi[c] = dOs[i * (D + 1) + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = Pw[r * kTile + i], ds = DSw[r * kTile + i];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc_dv[r][c] = fmaf(p, doi[c], acc_dv[r][c]);
          acc_dk[r][c] = fmaf(ds, qi[c], acc_dk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!key_ok[r]) continue;
    const size_t off = base + (size_t)(k0 + warp * R + r) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + lane + 32 * c] = acc_dk[r][c] * scale;
      dv[off + lane + 32 * c] = acc_dv[r][c];
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   const float* dout, const float* lse, const float* delta, float* dq,
                   float* dk, float* dv, float* dbias_part, int batch, int heads, int seq,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<D>();
  constexpr size_t smem_dkv = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid_dq(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
  flash_bwd_dq_kernel<D><<<grid_dq, kThreads, smem_dq, stream>>>(
      q, k, v, bias, dout, lse, delta, dq, dbias_part, heads, seq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int bk = kWarps * DkvRows<D>::value;
  const dim3 grid_dkv(batch * heads, (seq + bk - 1) / bk);
  flash_bwd_dkv_kernel<D><<<grid_dkv, kThreads, smem_dkv, stream>>>(
      q, k, v, bias, dout, lse, delta, dk, dv, heads, seq, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v, dout, dq, dk, dv:
// contiguous (B, H, S, D) f32; bias: contiguous (B, S) f32; lse, delta:
// (B, H, S) f32; dbias_part: (B*H, ceil(S / 64), S) f32, or null to skip the
// dbias partials. Launches K3 then K4 on `stream`. Returns the cudaError_t
// of the launches (0 = both launched).
extern "C" int ufnd_flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                            const float* bias, const float* dout,
                                            const float* lse, const float* delta, float* dq,
                                            float* dk, float* dv, float* dbias_part,
                                            int batch, int heads, int seq, int dim,
                                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 64: return launch<64>(q, k, v, bias, dout, lse, delta, dq, dk, dv, dbias_part,
                               batch, heads, seq, scale, s);
    case 128: return launch<128>(q, k, v, bias, dout, lse, delta, dq, dk, dv, dbias_part,
                                 batch, heads, seq, scale, s);
    case 192: return launch<192>(q, k, v, bias, dout, lse, delta, dq, dk, dv, dbias_part,
                                 batch, heads, seq, scale, s);
    case 256: return launch<256>(q, k, v, bias, dout, lse, delta, dq, dk, dv, dbias_part,
                                 batch, heads, seq, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
