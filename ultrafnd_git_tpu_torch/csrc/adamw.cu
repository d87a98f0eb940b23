// Fused AdamW update (K1) for Hopper: one multi-tensor launch per step.
//
// Replaces: ultrafnd_git_tpu/kernels/adamw.py::_adamw_kernel, launched once
// per parameter leaf by _leaf_update (leaves under 64k elements took a jnp
// path there). Same update, in the optax op order of
// clip_by_global_norm(c) -> adamw(schedule, wd):
//   g  = gnorm < clip ? g : (g / gnorm) * clip        (when clipping is on)
//   m  = (1 - b1) * g + b1 * m
//   v  = (1 - b2) * (g * g) + b2 * v
//   u  = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd * p
//   p  = p + (-lr) * u
// with p, m and v updated in place. The global norm is a torch reduction
// outside the kernel (as it is outside the Pallas call); it and the other
// scalars arrive in a 16-float device row whose slots are those of the
// TPU kernel: 0 gnorm, 1 clip, 2 b1, 3 b2, 4 eps, 5 wd, 6 -lr, 7 1-b1^t,
// 8 1-b2^t, 9 has_clip, 10 1-b1, 11 1-b2 (both computed on the host in
// f64 and rounded to f32, as optax bakes its constants). The wrapper
// (kernels/adamw.py::fused_adamw_) adds one to its `launches` counter per
// launch, one per optimizer step.
//
// Bit identity with the plain version (adamw_reference_, separate torch
// ops, each rounded once). nvcc would contract `a * b + c` into one FMA,
// which rounds once where torch rounds twice; the body therefore uses the
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn intrinsics, which are never
// contracted and round to nearest exactly as torch's kernels do.
//
// Design. The TPU kernel streams one leaf per call. Here the wrapper hands a
// device table of (p, m, v, g, numel, first block) rows, one per trainable
// leaf, and one launch covers every leaf: block b finds its leaf by a
// search over first-block offsets and streams its 4096-element chunk.
// What bounds it on the card: pure streaming, 7 f32 accesses (read p, m,
// v, g; write p, m, v) and about 15 flops per element, so memory: for the
// full-width tree (52.3 M parameters, 1.46 GB per step) the floor is
// about 0.44 ms at 3.35 TB/s (computed from shapes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // elements per block
constexpr int kCols = 6;      // table row: p, m, v, g, numel, first block

__global__ void __launch_bounds__(kThreads)
adamw_multi_tensor_kernel(const long long* __restrict__ table, int n_leaves,
                          const float* __restrict__ scal) {
  __shared__ int leaf_s;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_leaves - 1;  // last leaf whose first block <= blockIdx.x
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid * kCols + 5] <= (long long)blockIdx.x) lo = mid; else hi = mid - 1;
    }
    leaf_s = lo;
  }
  __syncthreads();
  const long long* row = table + leaf_s * kCols;
  float* p = reinterpret_cast<float*>(row[0]);
  float* m = reinterpret_cast<float*>(row[1]);
  float* v = reinterpret_cast<float*>(row[2]);
  const float* g = reinterpret_cast<const float*>(row[3]);
  const long long numel = row[4];
  const long long start = ((long long)blockIdx.x - row[5]) * kChunk;
  const long long end = start + kChunk < numel ? start + kChunk : numel;

  const float gnorm = scal[0], clip = scal[1], b1 = scal[2], b2 = scal[3];
  const float eps = scal[4], wd = scal[5], neg_lr = scal[6];
  const float bc1 = scal[7], bc2 = scal[8];
  const bool has_clip = scal[9] > 0.f;
  const float omb1 = scal[10], omb2 = scal[11];

  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    float gi = g[i];
    if (has_clip) {
      const float clipped = __fmul_rn(__fdiv_rn(gi, gnorm), clip);
      gi = gnorm < clip ? gi : clipped;
    }
    const float mi = __fadd_rn(__fmul_rn(omb1, gi), __fmul_rn(b1, m[i]));
    const float vi = __fadd_rn(__fmul_rn(omb2, __fmul_rn(gi, gi)), __fmul_rn(b2, v[i]));
    const float mh = __fdiv_rn(mi, bc1);
    const float vh = __fdiv_rn(vi, bc2);
    float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), eps));
    const float pi = p[i];
    u = __fadd_rn(u, __fmul_rn(wd, pi));
    p[i] = __fadd_rn(pi, __fmul_rn(neg_lr, u));
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). table: device int64 (n_leaves,
// 6) rows of (p, m, v, g pointers, numel, first block), first blocks
// ascending from 0; n_blocks: the total, sum of ceil(numel / 4096); scal:
// the device scalar row above. Launches one kernel on `stream` and returns
// its cudaError_t (0 = launched).
extern "C" int ufnd_adamw_f32(const long long* table, int n_leaves, long long n_blocks,
                              const float* scal, void* stream) {
  if (n_leaves <= 0 || n_blocks <= 0 || n_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  adamw_multi_tensor_kernel<<<(unsigned)n_blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(table, n_leaves, scal);
  return (int)cudaGetLastError();
}

extern "C" int ufnd_adamw_chunk() { return kChunk; }
