// Fused AdamW update (K1) for Hopper: one multi-tensor launch per step, a
// vectorised streaming pass over every leaf.
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
// What bounds it on the card: pure streaming, 7 f32 accesses (read p, m,
// v, g; write p, m, v) and about 18 operations per element, so memory: for
// the full-width tree (52.3 M parameters) 1.464 GB a step, 0.437 ms at
// 3.35 TB/s (computed from shapes). Design, so that the bytes set the pace:
//  * no search per block: the wrapper's cached device table holds, after
//    one (p, m, v, g, numel, aligned) row per leaf, one entry per block of
//    4096 elements, (leaf << 32) | chunk, so a block reaches its leaf with
//    two dependent loads;
//  * 16-byte accesses, all in flight at once: a thread loads its 4 float4
//    of each of p, m, v and g (16 loads) into registers before any
//    arithmetic, so no load waits behind a store. Plain loads and stores:
//    with streaming hints (__ldcs / __stcs) the same kernel was slower on
//    an H100 (PERF.md);
//  * a leaf whose numel is not a multiple of 4 finishes with a scalar tail;
//    a leaf whose four pointers are not all 16-byte aligned (the wrapper
//    checks each) takes the scalar path of the same kernel, one element a
//    thread. Nothing reads past a leaf.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                      // float4s of each array per thread
constexpr int kChunk = kThreads * kVec * 4;  // elements per block (4096)
constexpr int kCols = 6;  // leaf row: p, m, v, g, numel, aligned

struct Scalars {
  float gnorm, clip, b1, b2, eps, wd, neg_lr, bc1, bc2, omb1, omb2;
  bool has_clip;
};

__device__ __forceinline__ void update(float& p, float& m, float& v, float g, const Scalars& s) {
  if (s.has_clip) {
    const float clipped = __fmul_rn(__fdiv_rn(g, s.gnorm), s.clip);
    g = s.gnorm < s.clip ? g : clipped;
  }
  const float mi = __fadd_rn(__fmul_rn(s.omb1, g), __fmul_rn(s.b1, m));
  const float vi = __fadd_rn(__fmul_rn(s.omb2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
  const float mh = __fdiv_rn(mi, s.bc1);
  const float vh = __fdiv_rn(vi, s.bc2);
  float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), s.eps));
  u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, u));
  m = mi;
  v = vi;
}

__device__ __forceinline__ void update4(float4& p, float4& m, float4& v, const float4& g,
                                        const Scalars& s) {
  update(p.x, m.x, v.x, g.x, s);
  update(p.y, m.y, v.y, g.y, s);
  update(p.z, m.z, v.z, g.z, s);
  update(p.w, m.w, v.w, g.w, s);
}

__global__ void __launch_bounds__(kThreads)
adamw_multi_tensor_kernel(const long long* __restrict__ table, int n_leaves,
                          const float* __restrict__ scal) {
  const long long e = table[(size_t)n_leaves * kCols + blockIdx.x];
  const long long* row = table + (e >> 32) * kCols;
  const long long start = (e & 0xffffffffLL) * kChunk;
  float* __restrict__ p = reinterpret_cast<float*>(row[0]) + start;
  float* __restrict__ m = reinterpret_cast<float*>(row[1]) + start;
  float* __restrict__ v = reinterpret_cast<float*>(row[2]) + start;
  const float* __restrict__ g = reinterpret_cast<const float*>(row[3]) + start;
  const long long left = row[4] - start;
  const int n = left < kChunk ? (int)left : kChunk;
  const bool aligned = row[5] != 0;

  Scalars s;
  s.gnorm = scal[0], s.clip = scal[1], s.b1 = scal[2], s.b2 = scal[3];
  s.eps = scal[4], s.wd = scal[5], s.neg_lr = scal[6];
  s.bc1 = scal[7], s.bc2 = scal[8];
  s.has_clip = scal[9] > 0.f;
  s.omb1 = scal[10], s.omb2 = scal[11];

  if (aligned) {
    const int nv = n >> 2;  // whole float4s of the chunk
    float4 P[kVec], M[kVec], V[kVec], G[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < nv) {
        P[u] = reinterpret_cast<const float4*>(p)[i];
        M[u] = reinterpret_cast<const float4*>(m)[i];
        V[u] = reinterpret_cast<const float4*>(v)[i];
        G[u] = reinterpret_cast<const float4*>(g)[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < nv) {
        update4(P[u], M[u], V[u], G[u], s);
        reinterpret_cast<float4*>(p)[i] = P[u];
        reinterpret_cast<float4*>(m)[i] = M[u];
        reinterpret_cast<float4*>(v)[i] = V[u];
      }
    }
    const int i = 4 * nv + threadIdx.x;  // the leaf's last 1-3 elements
    if (i < n) {
      float pi = p[i], mi = m[i], vi = v[i];
      update(pi, mi, vi, g[i], s);
      p[i] = pi, m[i] = mi, v[i] = vi;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      float pi = p[i], mi = m[i], vi = v[i];
      update(pi, mi, vi, g[i], s);
      p[i] = pi, m[i] = mi, v[i] = vi;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). table: device int64, n_leaves
// rows of (p, m, v, g pointers, numel, aligned: 1 when all four pointers are
// 16-byte aligned), then n_blocks entries (leaf << 32) | chunk, one per
// block of ufnd_adamw_chunk() elements of a leaf (chunk < ceil(numel /
// chunk)); scal: the device scalar row above. Launches one kernel on
// `stream` and returns its cudaError_t (0 = launched).
extern "C" int ufnd_adamw_f32(const long long* table, int n_leaves, long long n_blocks,
                              const float* scal, void* stream) {
  if (n_leaves <= 0 || n_blocks <= 0 || n_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  adamw_multi_tensor_kernel<<<(unsigned)n_blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(table, n_leaves, scal);
  return (int)cudaGetLastError();
}

extern "C" int ufnd_adamw_chunk() { return kChunk; }
