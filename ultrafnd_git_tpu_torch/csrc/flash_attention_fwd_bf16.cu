// Flash-attention forward (K2), bf16 mode, for Hopper: bf16 q, k, v and out,
// both products on the tensor cores in bf16 with f32 accumulation, the
// softmax in f32.
//
// Replaces: ultrafnd_git_tpu/kernels/flash_attention.py::_make_fwd_kernel
// with mm_dtype=bfloat16 (launched by _pallas_forward, the default mode of
// flash_attention), as the tower runs it when it is cloned with
// dtype=bfloat16. Same outputs: s = (q k^T, f32 sums) * scale + bias in f32,
// with the (B, 1, 1, S) bf16 key-padding bias (0 or bf16(-1e9), never -inf)
// widened to f32; P = exp(s - m) rounded to bf16 for P V, which sums in f32;
// out = O / sum(P) (the f32 P) rounded to bf16; lse = m + log(sum P) in f32.
// The TPU kernel takes each row's max over all S at once. This one keeps a
// running max over key tiles (online softmax), so past one key tile P is
// rounded to bf16 relative to a partial max: the same function, rounded at
// other points. Keys past S in a ragged last tile are excluded outright;
// masked keys keep their bias, so a fully masked row gets the uniform
// softmax and lse = bf16(-1e9) + log S, never NaN. No float atomics: two
// calls give the same bits.
//
// Design. A CTA of 4 warps takes one batch*head (blockIdx.x) and a tile of
// BQ query rows (blockIdx.y) and walks its key tiles of BK = 64 keys. A warp
// owns 16 query rows: it computes their S = Q K^T over the whole key tile and
// O += P V for its D / WC output columns (WC = 2 at D >= 192: two warps share
// 16 rows and each computes S itself, so that O stays at 64 registers a
// thread). Both products are mma.sync.aligned.m16n8k16 bf16 -> f32.
//  * Operands come from shared memory by ldmatrix: Q's A fragment and K's B
//    fragment (rows of 8 bf16, 16 bytes) by ldmatrix.x4, V's B fragment by
//    ldmatrix.x4.trans (V is stored key-major, the product wants it
//    column-major). The tiles are XOR-swizzled in 16-byte chunks, chunk ^
//    (row % 8), so the 8 row addresses of every ldmatrix phase fall in 8
//    distinct bank groups.
//  * P never leaves registers. The C fragments of two adjacent 8-key tiles
//    of S hold, per thread, rows g and g + 8 at keys 2t, 2t + 1 of each: cast
//    to bf16 and packed in pairs (cvt.rn.bf16x2.f32), they are exactly the
//    A fragment of the k16 step of P V over those 16 keys (a0 = tile 2j's
//    c0 c1, a1 = its c2 c3, a2 = tile 2j + 1's c0 c1, a3 = its c2 c3), so
//    no permutation of V is needed.
//  * Q, K and V come in by cp.async (16 bytes a thread), Q and K as one copy
//    group and V as a second, so S = Q K^T starts while V is in flight.
//
// Constants (tests/test_torch_fwd_design.py mirrors them): kWarps = 4;
// WC = D <= 128 ? 1 : 2; BQ = 16 * kWarps / WC (64, or 32 at D >= 192);
// BK = 64; the swizzle swz. Shared memory: 2 (BQ + 2 BK) D bytes (48 KB at
// D = 128).
//
// What bounds it on the card (computed from shapes). At the serving shape
// (256, 6, 64, 128) the call reads q, k, v (bf16) and the bias and writes
// out (bf16) and lse (f32): 101.1 MB, 0.030 ms at 3.35 TB/s; its two
// products are 3.2 GFLOP, 0.003 ms at 989 TFLOP/s of dense bf16. So the
// bytes set the bound: the design reads each input once per CTA, keeps S and
// P in registers and overlaps the copies with the products of other CTAs.
// chip_smoke.py prints the ptxas report; PERF.md keeps the times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int D>
struct Cfg {
  static constexpr int WC = D <= 128 ? 1 : 2;  // warps sharing 16 query rows
  static constexpr int BQ = 16 * kWarps / WC;  // query rows per CTA
  static constexpr int BK = 64;                // keys per tile
  static constexpr int NT_S = BK / 8;          // 8-key tiles of a warp's S
  static constexpr int DW = D / WC;            // output columns per warp
  static constexpr int NT_O = DW / 8;          // 8-column tiles of a warp's O
  static constexpr size_t SMEM = sizeof(bf16) * (BQ + 2 * BK) * D;  // Q, K, V tiles
};

// Element offset of (r, c) in a swizzled (rows, W) bf16 shared tile, W >= 64:
// 16-byte chunk c / 8 of row r is stored at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c, int W) {
  return r * W + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));  // src-size 0 fills the 16 bytes with zeros
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and r[i] receives this lane's two elements of it.
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

// rows [r0, r0 + rows) of a (seq, D) bf16 matrix into a swizzled shared tile;
// rows past seq are zero-filled
template <int D>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int r0, int rows, int seq,
                                      int tid) {
  constexpr int C8 = D / 8;
  for (int i = tid; i < rows * C8; i += kThreads) {
    const int r = i / C8, c = (i % C8) * 8;
    const bool ok = r0 + r < seq;
    cp_async16(dst + swz(r, c, D), src + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ bias,
                      bf16* __restrict__ out, float* __restrict__ lse, int heads, int seq,
                      float scale) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NT_S = C::NT_S, NT_O = C::NT_O;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (BQ, D)
  bf16* Ks = Qs + BQ * D;                        // (BK, D)
  bf16* Vs = Ks + BK * D;                        // (BK, D)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row of matrix lm this lane addresses
  const int m0 = (warp / C::WC) * 16;       // the warp's query rows in the tile
  const int n0 = (warp % C::WC) * C::DW;    // and its output columns
  const int k_tiles = (seq + BK - 1) / BK;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const size_t base = (size_t)bh * seq * D;
  const bf16* brow = bias + (size_t)(bh / heads) * seq;

  auto load_tile = [&](int kt) {
    if (kt == 0) stage<D>(Qs, q + base, q0, BQ, seq, tid);
    stage<D>(Ks, k + base, kt * BK, BK, seq, tid);
    cp_async_commit();
    stage<D>(Vs, v + base, kt * BK, BK, seq, tid);
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
        bk[n][e] = key < seq ? __bfloat162float(brow[key]) : -INFINITY;
      }

    cp_async_wait<1>();
    __syncthreads();  // Q and K of the tile in place

    // S = Q K^T: the warp's 16 rows x BK keys. Q's matrices: rows m0 + 8 (i & 1),
    // depths kk + 8 (i >> 1); K's: keys 16 np + 8 (i >> 1), depths kk + 8 (i & 1)
    float sacc[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, Qs + swz(m0 + lr + 8 * (lm & 1), kk + 8 * (lm >> 1), D));
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, Ks + swz(16 * np + lr + 8 * (lm >> 1), kk + 8 * (lm & 1), D));
        mma(sacc[2 * np], a, b);
        mma(sacc[2 * np + 1], a, b + 2);
      }
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
      mx[h] = fmaxf(m[h], mx[h]);     // finite: key k0 < seq is in every tile
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
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[e >> 1];
    cp_async_wait<0>();
    __syncthreads();  // V of the tile in place

    // O += P V, one k16 step per 16 keys: P's C fragments of 8-key tiles 2j
    // and 2j + 1, packed to bf16, are the A fragment; V's matrices: keys
    // 16 j + 8 (i & 1), columns n0 + 16 np + 8 (i >> 1), transposed
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a[4] = {pack(sacc[2 * j][0], sacc[2 * j][1]),
                             pack(sacc[2 * j][2], sacc[2 * j][3]),
                             pack(sacc[2 * j + 1][0], sacc[2 * j + 1][1]),
                             pack(sacc[2 * j + 1][2], sacc[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, Vs + swz(16 * j + lr + 8 * (lm & 1), n0 + 16 * np + 8 * (lm >> 1), D));
        mma(oacc[2 * np], a, b);
        mma(oacc[2 * np + 1], a, b + 2);
      }
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
    bf16* orow = out + base + (size_t)row * D + n0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack(oacc[n][2 * h] / l[h], oacc[n][2 * h + 1] / l[h]);
    }
    if (t == 0 && n0 == 0) lse[(size_t)bh * seq + row] = m[h] + logf(l[h]);
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
  err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  done.fetch_or(bit);
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* bias, bf16* out,
                   float* lse, int batch, int heads, int seq, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const long long bh = (long long)batch * heads, q_tiles = (seq + C::BQ - 1) / C::BQ;
  if (bh > 0x7fffffffLL || q_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)bh, (unsigned)q_tiles);
  const cudaError_t err = set_attributes<D>();
  if (err != cudaSuccess) return err;
  flash_fwd_bf16_kernel<D><<<grid, kThreads, C::SMEM, stream>>>(q, k, v, bias, out, lse, heads,
                                                                seq, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v, out: contiguous
// (B, H, S, D) bf16; bias: contiguous (B, S) bf16; lse: (B, H, S) f32.
// Returns the cudaError_t of the launch (0 = launched).
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
