// Flash-attention forward (K2) for Hopper, f32 in / f32 accumulate.
//
// Replaces: ultrafnd_git_tpu/kernels/flash_attention.py::_make_fwd_kernel
// (launched by _pallas_forward). Same outputs: out = softmax(q k^T * scale
// + bias) v and the per-row lse = m + log(sum exp(s - m)), with the additive
// key-padding bias of shape (B, 1, 1, S) (0 or -1e9, never -inf).
//
// Design. The TPU kernel holds the whole K and V of one (batch, head) in
// VMEM and does one softmax over the full (BQ, S) score tile. Here one CTA
// owns one (batch*head, 64-query tile) and loops over 32-key tiles staged
// in shared memory, carrying the running row max and sum in f32 (the
// online-softmax form), so shared memory stays bounded at any S. 8 warps,
// each owning 8 query rows; in a key tile lane j owns key j for the score
// dot products and column group {lane + 32c} of the output accumulator.
// Keys past S (the ragged last tile) are excluded outright; masked keys
// keep the reference's -1e9 bias, so a fully masked row gives the same
// uniform softmax as the reference and never NaN.
//
// What bounds it on the card. At the serving shape S = 64, D = 128, each
// (b, h) reads 3 * 64 * 128 * 4 B = 96 KB and does 4 * 64^2 * 128 = 2.1
// MFLOP: about 21 flop per byte. Against the tensor cores (495 TFLOP/s
// TF32, 989 bf16) that is far below the ridge, so attention at this shape
// is bound by memory traffic (3.35 TB/s) and launch overhead; against the
// f32 CUDA cores (67 TFLOP/s) it sits at the ridge. The design reads q, k
// and v from device memory once per CTA (one query tile covers S = 64),
// keeps scores and probabilities in registers and shared memory, and
// writes only out and lse, so its device traffic is the minimum. What
// bounds this first version is its inner loops: scalar FMAs on the CUDA
// cores, fed from shared memory. wgmma on TMA-staged tiles and bf16
// inputs are the later levers.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;      // query rows per CTA
constexpr int kBlockK = 32;      // keys per shared-memory tile (one per lane)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 8
constexpr int kThreads = kWarps * 32;

template <int D>
constexpr size_t smem_bytes() {
  // Qs[BQ][D] + Ks[BK][D+1] (padded: lane j reads row j, conflict-free)
  // + Vs[BK][D] + Ps[warps][rows][BK]
  return sizeof(float) * (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D +
                          kWarps * kRowsPerWarp * kBlockK);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, float* __restrict__ lse,
                     int heads, int seq, float scale) {
  constexpr int NC = D / 32;  // output columns per lane
  constexpr int D4 = D / 4;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * D;
  float* Vs = Ks + kBlockK * (D + 1);
  float* Ps = Vs + kBlockK * D;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t base = (size_t)bh * seq * D;
  const float* brow = bias + (size_t)(bh / heads) * seq;

  // query tile, rows past S zero-filled (their results are never written)
  for (int i = tid; i < kBlockQ * D4; i += kThreads) {
    const int r = i / D4, c = (i % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < seq) x = *reinterpret_cast<const float4*>(q + base + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<float4*>(Qs + r * D + c) = x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  const float* Qw = Qs + warp * kRowsPerWarp * D;
  float* Pw = Ps + warp * kRowsPerWarp * kBlockK;

  for (int k0 = 0; k0 < seq; k0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed (and Qs written, first time)
    for (int i = tid; i < kBlockK * D4; i += kThreads) {
      const int r = i / D4, c = (i % D4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < seq) {
        const size_t off = base + (size_t)(k0 + r) * D + c;
        kx = *reinterpret_cast<const float4*>(k + off);
        vx = *reinterpret_cast<const float4*>(v + off);
      }
      float* kd = Ks + r * (D + 1) + c;
      kd[0] = kx.x; kd[1] = kx.y; kd[2] = kx.z; kd[3] = kx.w;
      *reinterpret_cast<float4*>(Vs + r * D + c) = vx;
    }
    __syncthreads();

    // scores of this lane's key against the warp's 8 query rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(Qw[r * D + d], kd, s[r]);
    }
    const bool valid = k0 + lane < seq;
    const float bj = valid ? brow[k0 + lane] : 0.f;

    // online softmax: rescale the running state to the new row max
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = valid ? s[r] * scale + bj : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));  // finite: lane 0 is valid
      const float alpha = expf(m[r] - m_new);         // 0 on the first tile
      const float p = valid ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      Pw[r * kBlockK + lane] = p;
    }
    __syncwarp();

    const int kn = min(kBlockK, seq - k0);
    for (int j = 0; j < kn; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vj[c] = Vs[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = Pw[r * kBlockK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= seq) continue;
    float* orow = out + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[lane + 32 * c] = acc[r][c] / l[r];
    if (lane == 0) lse[(size_t)bh * seq + row] = m[r] + logf(l[r]);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   float* out, float* lse, int batch, int heads, int seq, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, bias, out, lse,
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
