"""PyTorch port, K2's design on the CPU: a numpy emulation of the tensor-core
forward in csrc/flash_attention_fwd.cu, and a bank-conflict check of its
shared-memory fragment loads. No nvcc or GPU needed.

(a) The emulation runs the kernel's algorithm with the kernel's own
constants (kWarps, WC, BQ, BK, vrow; swz, split and the m16n8k8 fragment
layouts of csrc/tf32_mma.cuh): shared tiles staged at their swizzled
addresses (V's rows permuted), every fragment gathered lane by lane, each
mma.sync as one 16 x 8 x 8 product rebuilt from the 32 lanes' fragments
(TF32 operands as the hardware reads them, the low part of the split cut
to its top 19 bits; the sum rounded to f32), the 3xTF32 terms in the
kernel's order, the online softmax over key tiles on the accumulator
fragments in f32 (quad reductions in the kernel's order), P's C fragment
reused as PV's A fragment, and each key tile's P V added to O in f32. It is
held to the port's plain `reference_attention` and to the JAX Pallas
forward in interpret mode with f32 matmuls at atol = rtol = 2e-5 (the JAX
suite's tolerance) and within 1e-5 of max|plain|.

(b) For every shared-memory fragment load of the forward (Q's A fragment
and K's B fragment, 64-bit; V's B fragment, 32-bit) and of the backward
(its 32- and 64-bit A, A-transposed and B loads), each lane's bank under
the swizzle: no two lanes of one phase (32 lanes for 32-bit loads, 16 for
64-bit) touch different words of one bank. P's A fragment is read from
registers, never from shared memory.

(c) K2's bf16 mode (csrc/flash_attention_fwd_bf16.cu), a TMA + wgmma
kernel: the shared-memory image as its tensor maps' 128-byte swizzle
writes it, every wgmma operand read back through descriptors built from
the kernel's own constants (parsed from the source), the online softmax
on the m64 accumulator fragments, P packed to bf16 as the register A
fragment of P V, out through the swizzled staging tile and a clipping
TMA store; held to `reference_attention_bf16` and to the Pallas forward
in its bf16 mode at 8e-3 of max|ref| and lse at 1e-4. The descriptors
give back Q, K and V exactly at every width, and each width's ring fits
the SM. A wrong LBO, SBO, k-step, swizzle mode or transpose bit fails
these tests.

(d) K3/K4's bf16 mode (csrc/flash_attention_bwd_bf16.cu), the same way:
S and dP by ldmatrix, P and dS rounded to bf16 into swizzled query-major
tiles (a second swizzle for the 4-chunk rows of BK = 32), their transposed
A fragments for dV = P^T dO and dK = dS^T Q by ldmatrix.trans, dO and Q as
B by ldmatrix.trans, dQ = dS K with K by ldmatrix.trans, the dbias sums by
the kernel's shuffles, held to `attention_bwd_reference_bf16` and to the
Pallas bf16 backward in interpret mode at 8e-3 of max|ref|; every ldmatrix
and cp.async phase touches 8 distinct 16-byte bank groups and every P/dS
store 32 distinct banks. Breaking a pairing (matrix order, .trans) or the
BK = 32 swizzle fails these tests.

(e) The BERT rung's 3xTF32 GEMM (csrc/gemm_tf32x3.cu): the split of W in
`kernels/gemm_tf32x3.split_tf32` against the mirror of tf32_mma.cuh's split;
the kernel's sums (three terms as the tensor cores read them, a 32-deep
stage summed from zero and the stages added in f32; Kahan a k8 step under
129 rows) within 2e-6 of the f64 product at bert-base's widths, where one
TF32 term is 10x farther off; the X tile as the tensor map's swizzle lays
it out, read back through the kernel's own A-fragment addresses (each load
32 distinct banks) and the W tiles through its descriptors; each tile
width's ring inside the SM. Constants are parsed from the source.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.kernels.flash_attention import (
    _pallas_forward,
    padding_bias as jax_padding_bias,
)
from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"
TOL = dict(atol=2e-5, rtol=2e-5)
REL = 1e-5

# the kernel's constants (csrc/flash_attention_fwd.cu, Cfg)
K_WARPS = 4
CG = 4


def cfg(d):
    """(WC, BQ, BK) of head width d."""
    wc = 1 if d <= 128 else 2
    return wc, 16 * K_WARPS // wc, 64 if d <= 128 else 32


G = np.arange(32) // 4  # lane -> g
T = np.arange(32) % 4  # lane -> t
F32 = np.float32


def swz(r, c, w):
    h = ((r & 3) << 1) | ((r >> 2) & 1)
    return r * w + (((c >> 2) ^ h) << 2) + (c & 3)


def vrow(j):
    return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1)


def split(x):
    """(hi, lo) of `split`, each as the MMA reads it (TF32: top 19 bits)."""
    x = np.asarray(x, F32)
    hi = ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)
    lo = (x - hi).astype(F32)
    return hi, (lo.view(np.uint32) & np.uint32(0xFFFFE000)).view(F32)


def mma(c, a, b):
    """One mma.sync.m16n8k8 on lane fragments: c (..., 32, 4) += A B with
    A (16 x 8) from a (..., 32, 4) and B (8 x 8) from b (..., 32, 2)."""
    shape = np.broadcast_shapes(a.shape[:-2], b.shape[:-2], c.shape[:-2])
    A = np.zeros(shape + (16, 8))
    A[..., G, T], A[..., G + 8, T] = a[..., 0], a[..., 1]
    A[..., G, T + 4], A[..., G + 8, T + 4] = a[..., 2], a[..., 3]
    B = np.zeros(shape + (8, 8))
    B[..., T, G], B[..., T + 4, G] = b[..., 0], b[..., 1]
    C = np.zeros(shape + (16, 8))
    C[..., G, 2 * T], C[..., G, 2 * T + 1] = c[..., 0], c[..., 1]
    C[..., G + 8, 2 * T], C[..., G + 8, 2 * T + 1] = c[..., 2], c[..., 3]
    D = (C + A @ B).astype(F32)
    return np.stack([D[..., G, 2 * T], D[..., G, 2 * T + 1],
                     D[..., G + 8, 2 * T], D[..., G + 8, 2 * T + 1]], axis=-1)


def mma3(c, a, b):
    """3xTF32, the small terms first: lo_a hi_b, hi_a lo_b, hi_a hi_b."""
    (ah, al), (bh, bl) = split(a), split(b)
    return mma(mma(mma(c, al, bh), ah, bl), ah, bh)


def stage(x, r0, rows, permute=False):
    """Rows [r0, r0 + rows) of x (BH, S, D) as swizzled shared tiles
    (BH, rows * D), zero past S; V's rows permuted by vrow."""
    bh, s, d = x.shape
    r = np.arange(rows)
    tile = np.zeros((bh, rows, d), F32)
    ok = r0 + r < s
    tile[:, ok] = x[:, r0 + r[ok]]
    sm = np.zeros((bh, rows * d), F32)
    sm[:, swz((vrow(r) if permute else r)[:, None], np.arange(d)[None], d)] = tile
    return sm


def emulate_fwd(q, k, v, bias):
    """K2 on lane fragments: q, k, v (B, H, S, D) f32, bias (B, S) f32 ->
    (out (B, H, S, D), lse (B, H, S))."""
    b, h, s, d = q.shape
    wc, bq, bk = cfg(d)
    nt_s, dw = bk // 8, d // wc
    nt_o = dw // 8
    scale = F32(1.0) / np.sqrt(F32(d))
    qf, kf, vf = (x.reshape(b * h, s, d) for x in (q, k, v))
    brow = np.repeat(bias, h, axis=0)  # (BH, S): row bh // heads
    warp = np.arange(K_WARPS)
    m0, n0 = (warp // wc) * 16, (warp % wc) * dw
    q_tiles, k_tiles = -(-s // bq), -(-s // bk)
    out = np.zeros((b * h, q_tiles * bq, d), F32)
    lse = np.zeros((b * h, q_tiles * bq), F32)
    e_row = np.arange(4) >> 1  # accumulator element -> row half h
    for qt in range(q_tiles):
        qs = stage(qf, qt * bq, bq)
        m = np.full((b * h, K_WARPS, 32, 2), -np.inf, F32)
        l = np.zeros((b * h, K_WARPS, 32, 2), F32)
        o = np.zeros((b * h, K_WARPS, nt_o, 32, 4), F32)
        for kt in range(k_tiles):
            k0 = kt * bk
            ks, vs = stage(kf, k0, bk), stage(vf, k0, bk, permute=True)
            # S = Q K^T: load_a2 (Q rows m0 + g, m0 + g + 8; depths 2t, 2t+1)
            # and load_bt2 (K rows 8n + g; depths 2t, 2t+1)
            sacc = np.zeros((b * h, K_WARPS, nt_s, 32, 4), F32)
            for kk in range(0, d, 8):
                a0 = swz(m0[:, None] + G, kk + 2 * T, d)  # (W, 32)
                a1 = swz(m0[:, None] + G + 8, kk + 2 * T, d)
                a = np.stack([qs[:, a0], qs[:, a1], qs[:, a0 + 1], qs[:, a1 + 1]], axis=-1)
                bb = swz(8 * np.arange(nt_s)[:, None] + G, kk + 2 * T, d)  # (NT_S, 32)
                bfrag = np.stack([ks[:, bb], ks[:, bb + 1]], axis=-1)
                sacc = mma3(sacc, a[:, :, None], bfrag[:, None])
            # online softmax on the fragments
            keys = (k0 + 8 * np.arange(nt_s)[:, None, None] + 2 * T[None, :, None]
                    + (np.arange(4) & 1)[None, None, :])  # (NT_S, 32, 4)
            bval = brow[:, np.minimum(keys, s - 1)][:, None]
            x = np.where(keys < s, ((sacc * scale).astype(F32) + bval).astype(F32), -np.inf)
            x = x.astype(F32)
            mx = np.full((b * h, K_WARPS, 32, 2), -np.inf, F32)
            for n in range(nt_s):
                for e in range(4):
                    mx[..., e >> 1] = np.maximum(mx[..., e >> 1], x[:, :, n, :, e])
            for off in (1, 2):  # __shfl_xor_sync over the quad
                mx = np.maximum(mx, mx[:, :, np.arange(32) ^ off])
            m_new = np.maximum(m, mx)
            alpha = np.exp((m - m_new).astype(F32)).astype(F32)
            m = m_new
            p = np.exp((x - m[:, :, None, :, e_row]).astype(F32)).astype(F32)
            tot = np.zeros((b * h, K_WARPS, 32, 2), F32)
            for n in range(nt_s):
                for e in range(4):
                    tot[..., e >> 1] = (tot[..., e >> 1] + p[:, :, n, :, e]).astype(F32)
            for off in (1, 2):
                tot = (tot + tot[:, :, np.arange(32) ^ off]).astype(F32)
            l = ((l * alpha).astype(F32) + tot).astype(F32)
            # O = alpha O + P V: P's C fragment (c0, c2, c1, c3) is the A
            # fragment; load_b of V reads rows 8kn + t, 8kn + t + 4 (keys
            # 8kn + 2t, 8kn + 2t + 1 after vrow), columns n0 + 8n + g
            for n in range(0, nt_o, CG):
                pv = np.zeros((b * h, K_WARPS, CG, 32, 4), F32)
                cols = n0[:, None, None] + 8 * (n + np.arange(CG))[None, :, None] + G  # (W, CG, 32)
                for kn in range(nt_s):
                    a = p[:, :, kn][..., [0, 2, 1, 3]]
                    b0, b1 = swz(8 * kn + T, cols, d), swz(8 * kn + T + 4, cols, d)
                    bfrag = np.stack([vs[:, b0], vs[:, b1]], axis=-1)
                    pv = mma3(pv, a[:, :, None], bfrag)
                scaled = (o[:, :, n:n + CG] * alpha[:, :, None, :, e_row]).astype(F32)
                o[:, :, n:n + CG] = (scaled + pv).astype(F32)
        if wc == 2:  # the two warps of a row group computed the same softmax
            assert np.array_equal(m[:, 0::2], m[:, 1::2]) and np.array_equal(l[:, 0::2], l[:, 1::2])
        for w in range(K_WARPS):
            for hh in range(2):
                rows = qt * bq + m0[w] + G + 8 * hh  # (32,)
                for n in range(nt_o):
                    for j in range(2):
                        col = n0[w] + 8 * n + 2 * T + j
                        out[:, rows, col] = (o[:, w, n, :, 2 * hh + j] / l[:, w, :, hh]).astype(F32)
                lse[:, rows] = (m[:, w, :, hh] + np.log(l[:, w, :, hh]).astype(F32)).astype(F32)
    return (out[:, :s].reshape(b, h, s, d), lse[:, :s].reshape(b, h, s))


CASES = {
    # name: (B, H, S, D, per-batch valid lengths)
    "s64_d128": (2, 2, 64, 128, [64, 37]),
    "ragged_s100_d64": (2, 2, 100, 64, [100, 63]),
    "fully_masked_row": (2, 2, 64, 128, [0, 17]),
    "key_tiles_d192": (2, 1, 80, 192, [80, 45]),  # 3 key tiles of 32, 3 query tiles
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_matches_plain_and_pallas(case):
    b, h, s, d, lengths = CASES[case]
    rng = np.random.default_rng(len(case) + d)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(F32) for _ in range(3))
    mask = (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(F32)
    tbias = fa.padding_bias(torch.from_numpy(mask))
    out, lse = emulate_fwd(q, k, v, tbias.numpy().reshape(b, s))
    ref_out, ref_lse = (x.numpy() for x in fa.reference_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), tbias))
    jax_out, jax_lse = _pallas_forward(
        *map(jnp.asarray, (q, k, v)), jax_padding_bias(jnp.asarray(mask)),
        block_q=128, interpret=True, mm_dtype=jnp.float32)
    for ref, ref_l in ((ref_out, ref_lse), (np.asarray(jax_out), np.asarray(jax_lse))):
        np.testing.assert_allclose(out, ref, **TOL)
        np.testing.assert_allclose(lse, ref_l.reshape(lse.shape), **TOL)
        assert np.abs(out - ref).max() <= REL * np.abs(ref).max()
    assert np.isfinite(out).all() and np.isfinite(lse).all()
    if mask[0].sum() == 0:  # uniform over the keys, lse = -1e9 + log S
        np.testing.assert_allclose(out[0], np.broadcast_to(v[0].mean(1, keepdims=True), v[0].shape),
                                   **TOL)
        np.testing.assert_allclose(lse[0], F32(-1e9) + np.log(F32(s)), rtol=1e-7)


def test_p_fragment_is_the_pv_a_fragment():
    """With depth t <-> key 2t and t + 4 <-> key 2t + 1 and V's rows permuted
    by vrow, the 16 x 8 C fragment of P, taken as (c0, c2, c1, c3), times the
    B fragments loaded from the permuted V tile is exactly P V."""
    rng = np.random.default_rng(0)
    P = rng.integers(-8, 8, size=(16, 8)).astype(F32)  # exact in TF32
    V = rng.integers(-8, 8, size=(8, 64)).astype(F32)
    c = np.stack([P[G, 2 * T], P[G, 2 * T + 1], P[G + 8, 2 * T], P[G + 8, 2 * T + 1]], axis=-1)
    vs = stage(V[None], 0, 8, permute=True)[0].reshape(-1)
    for n in range(8):
        b = np.stack([vs[swz(T, 8 * n + G, 64)], vs[swz(T + 4, 8 * n + G, 64)]], axis=-1)
        got = mma(np.zeros((32, 4), F32), c[:, [0, 2, 1, 3]], b)
        want = P @ V[:, 8 * n:8 * n + 8]
        np.testing.assert_array_equal(
            got, np.stack([want[G, 2 * T], want[G, 2 * T + 1], want[G + 8, 2 * T],
                           want[G + 8, 2 * T + 1]], axis=-1))


def _conflicts(words, width):
    """Phases of a warp's load in which two lanes touch different words of
    one bank; `words` (32,) is each lane's first 4-byte word, `width` 1 or
    2 words a lane (16 lanes a phase for 64-bit loads)."""
    lanes = 32 // width
    bad = []
    for ph in range(width):
        touched = {}
        for lane in range(ph * lanes, (ph + 1) * lanes):
            for j in range(width):
                w = int(words[lane]) + j
                touched.setdefault(w % 32, set()).add(w)
        bad += [bank for bank, ws in touched.items() if len(ws) > 1]
    return bad


def _fwd_loads(d):
    """Every shared fragment load of the forward at head width d: (name,
    lane words, width) for each k-step, tile and warp."""
    wc, _, bk = cfg(d)
    dw = d // wc
    for w in range(K_WARPS):
        m0, n0 = (w // wc) * 16, (w % wc) * dw
        for kk in range(0, d, 8):
            yield f"Q load_a2 w{w} kk{kk}", swz(m0 + G, kk + 2 * T, d), 2
            yield f"Q load_a2 +8 w{w} kk{kk}", swz(m0 + G + 8, kk + 2 * T, d), 2
            for n in range(bk // 8):
                yield f"K load_bt2 w{w} kk{kk} n{n}", swz(8 * n + G, kk + 2 * T, d), 2
        for kn in range(bk // 8):
            for n in range(dw // 8):
                col = n0 + 8 * n + G
                yield f"V load_b w{w} kn{kn} n{n}", swz(8 * kn + T, col, d), 1
                yield f"V load_b +4 w{w} kn{kn} n{n}", swz(8 * kn + T + 4, col, d), 1


def _bwd_loads(d):
    """The backward's fragment patterns (load_a, load_at, load_b at the
    widths it uses them: its tiles are BK x D, BQ x D and BQ x BK)."""
    bk = 64 if d <= 128 else 32
    for w_ in (d, bk):
        for r0 in range(0, 32, 8):
            for c0 in range(0, w_, 8):
                yield f"load_a W{w_}", swz(r0 + G, c0 + T, w_), 1
                yield f"load_a +4 W{w_}", swz(r0 + G, c0 + T + 4, w_), 1
                yield f"load_at W{w_}", swz(r0 + T, c0 + G, w_), 1
                yield f"load_b W{w_}", swz(r0 + T + 4, c0 + G, w_), 1
                yield f"load_a2 W{w_}", swz(r0 + G, c0 + 2 * T, w_), 2


@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_fragment_loads_are_free_of_bank_conflicts(kernel, d):
    loads = list((_fwd_loads if kernel == "fwd" else _bwd_loads)(d))
    assert loads
    for name, words, width in loads:
        assert len(set(words.tolist())) == 32, name  # 32 distinct fragment elements
        assert not _conflicts(words, width), name


def test_emulation_mirrors_the_kernel_sources():
    """The constants and index functions above are those of the sources."""
    fwd = (CSRC / "flash_attention_fwd.cu").read_text()
    hdr = (CSRC / "tf32_mma.cuh").read_text()
    for needle in ("constexpr int kWarps = 4;", "WC = D <= 128 ? 1 : 2;",
                   "BQ = 16 * kWarps / WC;", "BK = D <= 128 ? 64 : 32;", "CG = 4;",
                   "return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);",
                   "split(sacc[kn][0], ah[0], al[0]);", "split(sacc[kn][2], ah[1], al[1]);",
                   "split(sacc[kn][1], ah[2], al[2]);", "split(sacc[kn][3], ah[3], al[3]);",
                   '#include "tf32_mma.cuh"'):
        assert needle in fwd, needle
    for needle in ("const int h = ((r & 3) << 1) | ((r >> 2) & 1);",
                   "return r * W + ((((c >> 2) ^ h)) << 2) + (c & 3);",
                   "hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                   "for (int n = 0; n < N; ++n) mma(c[n], al, bh[n]);"):
        assert needle in hdr, needle
    assert re.search(r'#include "tf32_mma\.cuh"', (CSRC / "flash_attention_bwd.cu").read_text())


# ---------------------------------------------------------------------------
# K2's bf16 mode (csrc/flash_attention_fwd_bf16.cu): TMA loads into tiles
# with the 128-byte swizzle, S = Q K^T and O += P V by wgmma through shared
# memory descriptors (V MN-major by the transpose bit), P from S's
# accumulator fragments in registers, out through a swizzled staging tile
# and a TMA store. The emulation below writes the shared-memory image as the
# tensor map's swizzle lays it out, reads every wgmma operand back through
# descriptors built from the kernel's own constants (parsed from the source:
# a mutated LBO, SBO, swizzle mode, transpose bit or map swizzle changes
# what it reads), runs the online softmax on the m64 accumulator fragments
# and feeds the packed P fragment to the second product. Held to
# `reference_attention_bf16` and to the JAX Pallas forward in its bf16 mode
# at 8e-3 of max|ref| (one bf16 ulp at the top of the range) and lse at
# 1e-4 (relative where |lse| > 1).

LR, LM = np.arange(32) & 7, np.arange(32) >> 3  # ldmatrix: lane -> (row, matrix)
FWD16 = CSRC / "flash_attention_fwd_bf16.cu"
SWIZZLE_BITS = {0: 0, 1: 3, 2: 2, 3: 1}  # descriptor layout type -> XOR bits
MAP_BITS = {128: 3, 64: 2, 32: 1}  # CU_TENSOR_MAP_SWIZZLE_<n>B -> XOR bits


def to_bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(torch.bfloat16).float().numpy()


def kernel_constants():
    """The bf16 forward's box, atom and descriptor constants, and its tensor
    maps' swizzle, read from its source."""
    src = FWD16.read_text()
    names = ("kBox", "kAtomBytes", "kSwizzleMode", "kQKLbo", "kQKSbo", "kKStepBytes",
             "kVLbo", "kVSbo", "kVStepBytes", "kTnspV")
    out = {}
    for name in names:
        m = re.search(rf"constexpr (?:uint32_t|int) {name} = (\d+);", src)
        assert m, name
        out[name] = int(m.group(1))
    maps = set(re.findall(r"CU_TENSOR_MAP_SWIZZLE_(\d+)B", src))
    assert len(maps) == 1, maps
    out["map_bits"] = MAP_BITS[int(maps.pop())]
    return out


def swizzle(addr, bits):
    """XOR byte-address bits [4, 4 + bits) with bits [7, 7 + bits)."""
    return addr ^ (((addr >> 7) & ((1 << bits) - 1)) << 4)


def make_desc(addr, lbo, sbo, mode):
    """The kernel's `desc`: a wgmma shared-memory matrix descriptor."""
    return ((addr & 0x3FFFF) >> 4) | (lbo >> 4) << 16 | (sbo >> 4) << 32 | mode << 62


def desc_read(img, desc, mn, tnsp):
    """The (mn, 16) operand a wgmma reads through `desc` from the images
    img (BH, bytes / 2): row i of M or N, column k of K. K-major: rows of
    one swizzle span, 8-row groups SBO apart. MN-major (the transpose bit):
    MN runs of one span, LBO apart; K rows one span apart, 8-row groups SBO
    apart. Addresses swizzle by the descriptor's layout type."""
    start, lbo = (desc & 0x3FFF) << 4, ((desc >> 16) & 0x3FFF) << 4
    sbo, bits = ((desc >> 32) & 0x3FFF) << 4, SWIZZLE_BITS[desc >> 62]
    span = 16 << bits
    i, k = np.arange(mn)[:, None], np.arange(16)[None, :]
    if tnsp:
        per = span // 2
        lin = start + (i % per) * 2 + (i // per) * lbo + (k % 8) * span + (k // 8) * sbo
    else:
        lin = start + (i // 8) * sbo + (i % 8) * span + k * 2
    return img[:, swizzle(lin, bits) // 2]


def tma_load(img, x, r0, dst, kc):
    """The producer's loads of one 64 x D tile: rows [r0, r0 + 64) of x (BH,
    S, D), one (64, 64, 1) box per 64 columns at dst + a * atom, each row of
    128 bytes at the map's swizzle; rows past S read as zeros."""
    box = kc["kBox"]
    r, c = np.arange(box)[:, None], np.arange(box)[None, :]
    for a in range(x.shape[2] // box):
        rows = x[:, np.minimum(r0 + r, x.shape[1] - 1), a * box + c]
        rows = np.where(r0 + r < x.shape[1], rows, 0)
        img[:, swizzle(dst + a * kc["kAtomBytes"] + r * 2 * box + c * 2, kc["map_bits"]) // 2] = rows


def tma_store(img, out, r0, src, kc):
    """The consumer's store of one 64 x D out tile from the staging image at
    src into out (BH, S, D): the map's swizzle, rows past S clipped."""
    box = kc["kBox"]
    r, c = np.arange(box)[:, None], np.arange(box)[None, :]
    keep = np.arange(box) + r0 < out.shape[1]
    for a in range(out.shape[2] // box):
        tile = img[:, swizzle(src + a * kc["kAtomBytes"] + r * 2 * box + c * 2, kc["map_bits"]) // 2]
        out[:, r0 + np.arange(box)[keep], a * box:(a + 1) * box] = tile[:, keep]


# the m64 accumulator layout: thread (warp w, lane) element 4n + e holds row
# 16w + g + 8 (e >> 1), column 8n + 2t + (e & 1)
_W, _N, _L, _E = np.ix_(np.arange(4), np.arange(8), np.arange(32), np.arange(4))
ACC_ROW = 16 * _W + G[_L] + 8 * (_E >> 1)
ACC_COL = 8 * _N + 2 * T[_L] + (_E & 1)


def pack_pv_a(p):
    """The kernel's pa[j]: accumulator fragments (..., 4 warps, 8 tiles, 32,
    4) packed to bf16 pairs -> (..., 4 steps, 4 warps, 32, 4 registers, 2)."""
    steps = []
    for j in range(4):
        lo, hi = p[..., 2 * j, :, :], p[..., 2 * j + 1, :, :]
        steps.append(np.stack([lo[..., 0:2], lo[..., 2:4], hi[..., 0:2], hi[..., 2:4]], axis=-2))
    return to_bf16(np.stack(steps, axis=-5))


def a_matrix(regs):
    """The (64, 16) A operand of an m64k16 wgmma from its register fragment
    (..., 4 warps, 32, 4, 2): warp w's rows 16w .. 16w + 15 in mma.sync's
    m16n8k16 A layout (a0 rows g, a1 g + 8, a2 g and a3 g + 8 at columns + 8)."""
    a = np.zeros(regs.shape[:-4] + (64, 16), F32)
    for w in range(4):
        for e in range(2):
            a[..., 16 * w + G, 2 * T + e] = regs[..., w, :, 0, e]
            a[..., 16 * w + G + 8, 2 * T + e] = regs[..., w, :, 1, e]
            a[..., 16 * w + G, 2 * T + 8 + e] = regs[..., w, :, 2, e]
            a[..., 16 * w + G + 8, 2 * T + 8 + e] = regs[..., w, :, 3, e]
    return a


def stage_out(img, o_tile, o, kc):
    """The epilogue's staging writes: o (BH, 64, D) bf16 values, each
    thread's pair (row r, columns 8i + 2t, + 1) at the kernel's address."""
    d = o.shape[2]
    for i in range(d // 8):
        for h in range(2):
            for w in range(4):
                r = 16 * w + G + 8 * h
                addr = (o_tile + (i // 8) * kc["kAtomBytes"] + r * 128
                        + (((i % 8) ^ (r & 7)) << 4) + T * 4)
                for j in range(2):
                    img[:, (addr + 2 * j) // 2] = o[:, r, 8 * i + 2 * T + j]


def emulate_fwd_bf16(q, k, v, bias):
    """K2's bf16 mode as the kernel runs it: q, k, v (B, H, S, D) and bias
    (B, S) (rounded to bf16 here) -> (out (B, H, S, D) bf16 values as f32,
    lse (B, H, S))."""
    kc = kernel_constants()
    b, h, s, d = q.shape
    box, atom, mode = kc["kBox"], kc["kAtomBytes"], kc["kSwizzleMode"]
    tile = (d // box) * atom
    q_slot, o_tile, k_slot, v_slot = 0, tile, 2 * tile, 3 * tile
    scale = F32(1.0) / np.sqrt(F32(d))
    qf, kf, vf = (to_bf16(x).reshape(b * h, s, d) for x in (q, k, v))
    brow = np.repeat(to_bf16(bias), h, axis=0)
    tiles = -(-s // box)
    img = np.zeros((b * h, 4 * tile // 2), F32)
    out = np.zeros((b * h, s, d), F32)
    lse = np.zeros((b * h, s), F32)
    for qt in range(tiles):
        tma_load(img, qf, qt * box, q_slot, kc)
        m = np.full((b * h, 4, 32, 2), -np.inf, F32)
        l = np.zeros((b * h, 4, 32, 2), F32)
        o = np.zeros((b * h, 64, d), F32)
        for kt in range(tiles):
            k0 = kt * box
            tma_load(img, kf, k0, k_slot, kc)
            tma_load(img, vf, k0, v_slot, kc)
            acc = np.zeros((b * h, 64, 64), F32)
            for kk in range(d // 16):
                off = (kk // 4) * atom + (kk % 4) * kc["kKStepBytes"]
                qa = desc_read(img, make_desc(q_slot + off, kc["kQKLbo"], kc["kQKSbo"], mode), 64, 0)
                kb = desc_read(img, make_desc(k_slot + off, kc["kQKLbo"], kc["kQKSbo"], mode), 64, 0)
                acc = (acc + qa @ kb.transpose(0, 2, 1)).astype(F32)
            sacc = acc[:, ACC_ROW, ACC_COL]  # (BH, 4 warps, 8 tiles, 32, 4)
            keys = k0 + ACC_COL
            bval = brow[:, np.minimum(keys, s - 1)]
            x = np.where(keys < s, ((sacc * scale).astype(F32) + bval).astype(F32), -np.inf)
            x = x.astype(F32)
            mx = np.full((b * h, 4, 32, 2), -np.inf, F32)
            for n in range(8):
                for e in range(4):
                    mx[..., e >> 1] = np.maximum(mx[..., e >> 1], x[:, :, n, :, e])
            for off in (1, 2):
                mx = np.maximum(mx, mx[:, :, np.arange(32) ^ off])
            m_new = np.maximum(m, mx)
            alpha = np.exp((m - m_new).astype(F32)).astype(F32)
            m = m_new
            p = np.exp((x - m[:, :, None, :, np.arange(4) >> 1]).astype(F32)).astype(F32)
            tot = np.zeros((b * h, 4, 32, 2), F32)
            for n in range(8):
                for e in range(4):
                    tot[..., e >> 1] = (tot[..., e >> 1] + p[:, :, n, :, e]).astype(F32)
            for off in (1, 2):
                tot = (tot + tot[:, :, np.arange(32) ^ off]).astype(F32)
            l = ((l * alpha).astype(F32) + tot).astype(F32)
            rows = 16 * np.arange(4)[:, None, None] + G[None, :, None] + 8 * np.arange(2)
            alpha_row = np.zeros((b * h, 64), F32)
            alpha_row[:, rows] = alpha
            o = (o * alpha_row[:, :, None]).astype(F32)
            pa = pack_pv_a(p)  # (BH, 4 steps, 4 warps, 32, 4, 2)
            for j in range(4):
                vb = desc_read(img, make_desc(v_slot + j * kc["kVStepBytes"], kc["kVLbo"],
                                              kc["kVSbo"], mode), d, kc["kTnspV"])
                o = (o + a_matrix(pa[:, j]) @ vb.transpose(0, 2, 1)).astype(F32)
        l_row, m_row = np.zeros((b * h, 64), F32), np.zeros((b * h, 64), F32)
        l_row[:, rows], m_row[:, rows] = l, m
        stage_out(img, o_tile, to_bf16(o * (F32(1) / l_row)[:, :, None]), kc)
        tma_store(img, out, qt * box, o_tile, kc)
        keep = qt * box + np.arange(64) < s
        lse[:, qt * box + np.arange(64)[keep]] = (m_row + np.log(l_row).astype(F32))[:, keep]
    return out.reshape(b, h, s, d), lse.reshape(b, h, s)


BF16_CASES = {
    "d64_ragged_s100": (2, 2, 100, 64, [100, 63]),  # 2 key tiles, the second ragged
    "d128_fully_masked_row": (2, 2, 64, 128, [0, 17]),
    "d192_key_tiles_s130": (2, 1, 130, 192, [130, 45]),  # 3 key and query tiles
    "d256_s77": (2, 1, 77, 256, [77, 0]),  # ragged, 4 atoms, a masked row
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_emulated_bf16_kernel_matches_twin_and_pallas(case):
    b, h, s, d, lengths = BF16_CASES[case]
    rng = np.random.default_rng(len(case) + d)
    q, k, v = (to_bf16(rng.standard_normal((b, h, s, d))) for _ in range(3))
    mask = (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(F32)
    tbias = fa.padding_bias(torch.from_numpy(mask), torch.bfloat16)
    out, lse = emulate_fwd_bf16(q, k, v, tbias.float().numpy().reshape(b, s))
    twin = fa.reference_attention_bf16(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                                       tbias)
    jout, jlse = _pallas_forward(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                 jax_padding_bias(jnp.asarray(mask), jnp.bfloat16),
                                 block_q=128, interpret=True, mm_dtype=jnp.bfloat16)
    for ref, ref_l in ((twin[0].float().numpy(), twin[1].numpy()),
                       (np.asarray(jout.astype(jnp.float32)), np.asarray(jlse))):
        assert np.abs(out - ref).max() <= 8e-3 * np.abs(ref).max()
        np.testing.assert_allclose(lse, ref_l.reshape(lse.shape), rtol=1e-4, atol=1e-4)
    assert np.isfinite(out).all() and np.isfinite(lse).all()


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_bf16_descriptors_read_back_q_k_v_and_the_store_writes_out(d):
    """Through the kernel's descriptors, the TMA image gives back Q's and
    K's k16 slices (K-major) and V's 16-key slices (MN-major) exactly, and
    the staging writes stored by TMA give back the out tile."""
    kc = kernel_constants()
    atom, mode = kc["kAtomBytes"], kc["kSwizzleMode"]
    tile = d // kc["kBox"] * atom
    rng = np.random.default_rng(d)
    x = rng.integers(-64, 64, size=(3, 1, 64, d)).astype(F32)  # exact in bf16
    img = np.zeros((1, 4 * tile // 2), F32)
    for i, slot in enumerate((0, 2 * tile, 3 * tile)):
        tma_load(img, x[i], 0, slot, kc)
    for kk in range(d // 16):
        off = (kk // 4) * atom + (kk % 4) * kc["kKStepBytes"]
        for i, slot in enumerate((0, 2 * tile)):
            got = desc_read(img, make_desc(slot + off, kc["kQKLbo"], kc["kQKSbo"], mode), 64, 0)
            np.testing.assert_array_equal(got[0], x[i, 0, :, 16 * kk:16 * kk + 16])
    for j in range(4):
        got = desc_read(img, make_desc(3 * tile + j * kc["kVStepBytes"], kc["kVLbo"], kc["kVSbo"],
                                       mode), d, kc["kTnspV"])
        np.testing.assert_array_equal(got[0], x[2, 0, 16 * j:16 * j + 16].T)
    back = np.zeros((1, 50, d), F32)  # S = 50: the store clips rows 50 .. 63
    stage_out(img, tile, x[:1, 0], kc)
    tma_store(img, back, 0, tile, kc)
    np.testing.assert_array_equal(back[0], x[0, 0, :50])


def test_bf16_p_fragment_is_the_pv_a_fragment():
    """S's accumulator fragments of 8-key tiles 2j and 2j + 1, packed in
    pairs, are the A fragment of P V's k16 step j under the m64 layout; with
    V read MN-major through its descriptor, the four steps give exactly P V."""
    kc = kernel_constants()
    rng = np.random.default_rng(0)
    P = rng.integers(-8, 8, size=(64, 64)).astype(F32)  # exact in bf16
    V = rng.integers(-8, 8, size=(1, 64, 128)).astype(F32)
    pa = pack_pv_a(P[ACC_ROW, ACC_COL])  # (4 steps, 4 warps, 32, 4, 2)
    for j in range(4):
        np.testing.assert_array_equal(a_matrix(pa[j]), P[:, 16 * j:16 * j + 16])
    img = np.zeros((1, 2 * kc["kAtomBytes"]), F32)
    tma_load(img, V, 0, 0, kc)
    o = np.zeros((64, 128), F32)
    for j in range(4):
        vb = desc_read(img, make_desc(j * kc["kVStepBytes"], kc["kVLbo"], kc["kVSbo"],
                                      kc["kSwizzleMode"]), 128, kc["kTnspV"])[0]
        o += a_matrix(pa[j]) @ vb.T
    np.testing.assert_array_equal(o, P @ V[0])


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_bf16_producer_registers_cover_the_consumers_raise(d):
    """setmaxnreg moves registers inside the CTA's allocation: at each width
    what the producer warpgroup gives up covers what the consumer warpgroups
    take, and a consumer's registers hold O, S, P and the bias. The numbers
    are read from the source."""
    src = FWD16.read_text()
    threads = int(re.search(r"__launch_bounds__\((\d+), 1\)", src).group(1))
    narrow, wide = map(int, re.search(r"NC = D <= 128 \? (\d) : (\d);", src).groups())
    producer = int(re.search(r"kProducerRegs = (\d+);", src).group(1))
    consumer = int(re.search(r"kConsumerRegs = (\d+);", src).group(1))
    nc = narrow if d <= 128 else wide
    entry = 65536 // threads // 8 * 8  # registers a thread at launch
    assert 128 * (entry - producer) >= nc * 128 * (consumer - entry)
    assert consumer >= d // 2 + 32 + 16 + 16


def test_bf16_emulation_mirrors_the_kernel_source():
    src = FWD16.read_text()
    for needle in (
        "static constexpr int NC = D <= 128 ? 2 : 1;", "static constexpr int NQ = 2;",
        "static constexpr int NS = D == 64 ? 4 : (D == 128 ? 2 : (D == 192 ? 3 : 2));",
        "__launch_bounds__(384, 1)", "static constexpr int kConsumerRegs = 232;",
        "static constexpr int kProducerRegs = 40;",
        "static constexpr size_t SMEM = 1024 + NC * PER_C + 8 * NC * NB;",
        "return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |",
        "(uint64_t)(sbo >> 4) << 32 | (uint64_t)kSwizzleMode << 62;",
        "const uint32_t off = (kk / 4) * kAtomBytes + (kk % 4) * kKStepBytes;",
        "wgmma_ss_n64(s, desc(q_slot(c, qs) + off, kQKLbo, kQKSbo),",
        "desc(k_slot(c, st) + off, kQKLbo, kQKSbo), kk > 0);",
        "wgmma_pv<D>(o, pa[j], desc(v_slot(c, st) + j * kVStepBytes, kVLbo, kVSbo));",
        "pa[j][0] = pack(s[8 * j + 0], s[8 * j + 1]);", "pa[j][1] = pack(s[8 * j + 2], s[8 * j + 3]);",
        "pa[j][2] = pack(s[8 * j + 4], s[8 * j + 5]);", "pa[j][3] = pack(s[8 * j + 6], s[8 * j + 7]);",
        "o_tile(c) + (i / 8) * kAtomBytes + r * 128 + (((i % 8) ^ (r & 7)) << 4) + tq * 4;",
        "const float inv = 1.f / l[h];",
        "pack(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv)",
        "o[i] *= alpha[(i >> 1) & 1];",
        'asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n" : "=r"(d) : "f"(hi), "f"(lo));',
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 ",
        '"%32, %33, p, 1, 1, 0, 0;\\n}\\n"',  # S: scale A, B; neither transposed
        '"n"(kTnspV));',
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes",
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group",
        "cp.async.bulk.wait_group.read 0;", "fence.proxy.async.shared::cta;",
        "const cuuint32_t box[3] = {kBox, kBox, 1}, unit[3] = {1, 1, 1};",
        "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE", "setmaxnreg.dec.sync.aligned.u32",
        "setmaxnreg.inc.sync.aligned.u32",
    ):
        assert needle in src, needle
    for n in (64, 128, 192, 256):  # O += P V at every width, P from registers
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 " in src
        assert f"wgmma_rs_n{n}(float (&d)[{n // 2}], const uint32_t (&a)[4]," in src
    for gone in ("mma.sync", "ldmatrix", "cp.async.cg", "cp.async.commit_group"):
        assert gone not in src, gone  # no per-thread copies or mma.sync left


def ldsm_x4(tile, addr, trans=False):
    """ldmatrix.x4 from tiles (BH, n): `addr` (..., 32) is each lane's row
    start (lanes 8i .. 8i + 7: the rows of matrix i). Returns each lane's
    (..., 32, 4, 2) registers: matrix i, elements (g, 2t + e), or (2t + e, g)
    transposed."""
    rows = tile[:, addr[..., None] + np.arange(8)]  # (BH, ..., 32 src lanes, 8)
    lane = np.arange(32)
    src = 8 * np.arange(4)[None, :, None] + (lane // 4)[:, None, None]  # (32, 4, 1)
    col = 2 * (lane % 4)[:, None, None] + np.arange(2)[None, None, :]  # (32, 1, 2)
    if trans:  # row 2t + e of matrix i, column g
        src = 8 * np.arange(4)[None, :, None] + col
        col = (lane // 4)[:, None, None]
    return rows[..., src, col]


def mma16(c, a, b):
    """mma.sync.m16n8k16 on lane fragments: c (..., 32, 4) += A B, A (16 x 16)
    from a (..., 32, 4, 2), B (16 x 8) from b (..., 32, 2, 2); sums in f32."""
    shape = np.broadcast_shapes(a.shape[:-3], b.shape[:-3], c.shape[:-2])
    A = np.zeros(shape + (16, 16))
    B = np.zeros(shape + (16, 8))
    for e in range(2):
        A[..., G, 2 * T + e], A[..., G + 8, 2 * T + e] = a[..., 0, e], a[..., 1, e]
        A[..., G, 2 * T + 8 + e], A[..., G + 8, 2 * T + 8 + e] = a[..., 2, e], a[..., 3, e]
        B[..., 2 * T + e, G], B[..., 2 * T + 8 + e, G] = b[..., 0, e], b[..., 1, e]
    C = np.zeros(shape + (16, 8))
    C[..., G, 2 * T], C[..., G, 2 * T + 1] = c[..., 0], c[..., 1]
    C[..., G + 8, 2 * T], C[..., G + 8, 2 * T + 1] = c[..., 2], c[..., 3]
    D = (C + A @ B).astype(F32)
    return np.stack([D[..., G, 2 * T], D[..., G, 2 * T + 1],
                     D[..., G + 8, 2 * T], D[..., G + 8, 2 * T + 1]], axis=-1)

# ---------------------------------------------------------------------------
# K3/K4's bf16 mode (csrc/flash_attention_bwd_bf16.cu): one pass per (batch *
# head, key block), m16n8k16 bf16 fragments with f32 sums. S and dP by
# ldmatrix (Q, dO rows as A; K, V rows as B); P and dS rounded to bf16 into
# query-major tiles; dV = P^T dO and dK = dS^T Q with the transposed A
# fragments by ldmatrix.trans of those tiles and dO, Q by ldmatrix.trans;
# dQ = dS K with dS by ldmatrix and K by ldmatrix.trans. Held to the twin
# `attention_bwd_reference_bf16` and to `jax.vjp` of the Pallas bf16 mode in
# interpret mode at 8e-3 of max|ref|.

BWD_WARPS = 8
BWD_BQ = 64


def cfg_bwd_bf16(d):
    """(BK, NT_A, KG, NPART, NT_C, NCH) of the bf16 backward at head width d."""
    bk = 64 if d <= 128 else 32
    kg = bk // 16
    npart = BWD_WARPS // kg
    return bk, bk // 16, kg, npart, d // (8 * npart), d // 64


def swzb(r, c, w):
    """Element offset of (r, c) in a swizzled bf16 (rows, w) tile of the
    backward: chunk ^ (r % 8) for w >= 64, chunk ^ ((r / 2) % 4) for w = 32."""
    shift, mask = (0, 7) if w >= 64 else (1, 3)
    return r * w + (((c >> 3) ^ ((r >> shift) & mask)) << 3) + (c & 7)


def stage_b(x, r0, rows):
    """Rows [r0, r0 + rows) of x (BH, S, W) as swizzled bf16 tiles, zero past S."""
    bh, s, w = x.shape
    r = np.arange(rows)
    tile = np.zeros((bh, rows, w), F32)
    ok = r0 + r < s
    tile[:, ok] = x[:, r0 + r[ok]]
    sm = np.zeros((bh, rows * w), F32)
    sm[:, swzb(r[:, None], np.arange(w)[None], w)] = tile
    return sm


def emulate_bwd_bf16(q, k, v, bias, out, lse, do):
    """The bf16 backward on lane fragments: q, k, v, out, dO (B, H, S, D)
    bf16 values, bias (B, S) bf16 values, lse (B, H, S) f32 -> (dq, dk, dv
    bf16 values as f32, dbias (B, S) f32), the wrapper's sums included."""
    b, h, s, d = q.shape
    bk, nt_a, kg, npart, nt_c, nch = cfg_bwd_bf16(d)
    scale = F32(1.0) / np.sqrt(F32(d))
    qf, kf, vf, of, dof = (to_bf16(x).reshape(b * h, s, d) for x in (q, k, v, out, do))
    lsef = lse.reshape(b * h, s).astype(F32)
    brow = np.repeat(to_bf16(bias), h, axis=0)
    warp = np.arange(BWD_WARPS)
    a_m0, a_n0 = (warp >> 1) * 16, (warp & 1) * (bk // 2)
    c_m0, c_n0 = (warp % kg) * 16, (warp // kg) * (d // npart)
    e_n0 = (warp & 1) * (d // 2)
    key_blocks = -(-s // bk)
    n_bh = b * h
    dq_slab = np.zeros((key_blocks, n_bh, s, d), F32)
    dk = np.zeros((n_bh, s, d), F32)
    dv = np.zeros((n_bh, s, d), F32)
    dbias_part = np.zeros((n_bh, s), F32)
    e_row, e_col = np.arange(4) >> 1, np.arange(4) & 1
    for kb in range(key_blocks):
        k0 = kb * bk
        ks, vs = stage_b(kf, k0, bk), stage_b(vf, k0, bk)
        kval = np.zeros((n_bh, bk), F32)
        kval[:, : min(bk, s - k0)] = brow[:, k0:k0 + bk]
        dk_acc = np.zeros((n_bh, BWD_WARPS, nt_c, 32, 4), F32)
        dv_acc = np.zeros((n_bh, BWD_WARPS, nt_c, 32, 4), F32)
        db = np.zeros((n_bh, BWD_WARPS, nt_a, 32, 2), F32)
        for q0 in range(0, s, BWD_BQ):
            qs, dos = stage_b(qf, q0, BWD_BQ), stage_b(dof, q0, BWD_BQ)
            rows_ok = q0 + np.arange(BWD_BQ) < s
            rr = np.minimum(q0 + np.arange(BWD_BQ), s - 1)
            delta = np.where(rows_ok, (dof[:, rr] * of[:, rr]).sum(-1, dtype=F32), 0).astype(F32)
            lsev = np.where(rows_ok, lsef[:, rr], 0).astype(F32)
            # S = Q K^T, dP = dO V^T
            sacc = np.zeros((n_bh, BWD_WARPS, nt_a, 32, 4), F32)
            pacc = np.zeros_like(sacc)
            for kk in range(0, d, 16):
                ar = swzb(a_m0[:, None] + LR + 8 * (LM & 1), kk + 8 * (LM >> 1), d)
                aq, ado = ldsm_x4(qs, ar), ldsm_x4(dos, ar)
                for n2 in range(nt_a // 2):
                    br = swzb(a_n0[:, None] + 16 * n2 + LR + 8 * (LM >> 1), kk + 8 * (LM & 1), d)
                    bkf, bvf = ldsm_x4(ks, br), ldsm_x4(vs, br)
                    for half in range(2):
                        sacc[:, :, 2 * n2 + half] = mma16(sacc[:, :, 2 * n2 + half], aq,
                                                          bkf[..., 2 * half:2 * half + 2, :])
                        pacc[:, :, 2 * n2 + half] = mma16(pacc[:, :, 2 * n2 + half], ado,
                                                          bvf[..., 2 * half:2 * half + 2, :])
            # P and dS on the fragments; bf16 copies into the (BQ, BK) tiles
            r = a_m0[:, None, None, None] + G[None, None, :, None] + 8 * e_row  # (W, 1, 32, 4)
            c = (a_n0[:, None, None, None] + 8 * np.arange(nt_a)[None, :, None, None]
                 + 2 * T[None, None, :, None] + e_col)  # (W, NT_A, 32, 4)
            r = np.broadcast_to(r, c.shape)
            x = ((sacc * scale).astype(F32) + kval[:, c]).astype(F32)
            ok = rows_ok[r] & (k0 + c < s)
            p = np.where(ok, np.exp((x - lsev[:, r]).astype(F32)), 0).astype(F32)
            ds = (p * (pacc - delta[:, r]).astype(F32)).astype(F32)
            ps, dss = np.zeros((n_bh, BWD_BQ * bk), F32), np.zeros((n_bh, BWD_BQ * bk), F32)
            ps[:, swzb(r, c, bk)] = to_bf16(p)
            dss[:, swzb(r, c, bk)] = to_bf16(ds)
            col = (ds[..., 0:2] + ds[..., 2:4]).astype(F32)  # (BH, W, NT_A, 32, 2)
            for off in (4, 8, 16):
                col = (col + col[..., np.arange(32) ^ off, :]).astype(F32)
            db = (db + col).astype(F32)
            # dV += P^T dO, dK += dS^T Q
            for kq in range(0, BWD_BQ, 16):
                pa_addr = swzb(kq + LR + 8 * (LM >> 1), c_m0[:, None] + 8 * (LM & 1), bk)
                pa, sa = ldsm_x4(ps, pa_addr, trans=True), ldsm_x4(dss, pa_addr, trans=True)
                for n2 in range(nt_c // 2):
                    baddr = swzb(kq + LR + 8 * (LM & 1), c_n0[:, None] + 16 * n2 + 8 * (LM >> 1), d)
                    bdo, bq = ldsm_x4(dos, baddr, trans=True), ldsm_x4(qs, baddr, trans=True)
                    for half in range(2):
                        sl = slice(2 * half, 2 * half + 2)
                        dv_acc[:, :, 2 * n2 + half] = mma16(dv_acc[:, :, 2 * n2 + half], pa, bdo[..., sl, :])
                        dk_acc[:, :, 2 * n2 + half] = mma16(dk_acc[:, :, 2 * n2 + half], sa, bq[..., sl, :])
            # dQ = dS K, 32 columns at a time
            sfrag = [ldsm_x4(dss, swzb(a_m0[:, None] + LR + 8 * (LM & 1), 16 * j + 8 * (LM >> 1), bk))
                     for j in range(bk // 16)]
            for ch in range(nch):
                qacc = np.zeros((n_bh, BWD_WARPS, 4, 32, 4), F32)
                for j in range(bk // 16):
                    for n2 in range(2):
                        kb_ = ldsm_x4(ks, swzb(16 * j + LR + 8 * (LM & 1),
                                               e_n0[:, None] + 32 * ch + 16 * n2 + 8 * (LM >> 1), d),
                                      trans=True)
                        for half in range(2):
                            qacc[:, :, 2 * n2 + half] = mma16(qacc[:, :, 2 * n2 + half], sfrag[j],
                                                              kb_[..., 2 * half:2 * half + 2, :])
                for w in range(BWD_WARPS):
                    for hh in range(2):
                        row = q0 + a_m0[w] + G + 8 * hh
                        keep = row < s
                        for n in range(4):
                            for jj in range(2):
                                colq = e_n0[w] + 32 * ch + 8 * n + 2 * T + jj
                                val = (qacc[:, w, n, :, 2 * hh + jj] * scale).astype(F32)
                                dq_slab[kb][:, row[keep], colq[keep]] = val[:, keep]
        for w in range(BWD_WARPS):
            for hh in range(2):
                key = k0 + c_m0[w] + G + 8 * hh
                keep = key < s
                for n in range(nt_c):
                    for jj in range(2):
                        colk = c_n0[w] + 8 * n + 2 * T + jj
                        dk[:, key[keep], colk[keep]] = to_bf16(
                            (dk_acc[:, w, n, :, 2 * hh + jj] * scale).astype(F32))[:, keep]
                        dv[:, key[keep], colk[keep]] = to_bf16(dv_acc[:, w, n, :, 2 * hh + jj])[:, keep]
        part = np.zeros((n_bh, 4, bk), F32)  # the four row groups' sums, lanes 0..3 of each warp
        for w in range(BWD_WARPS):
            for n in range(nt_a):
                for jj in range(2):
                    part[:, w >> 1, a_n0[w] + 8 * n + 2 * T[:4] + jj] = db[:, w, n, :4, jj]
        tot = (((part[:, 0] + part[:, 1]).astype(F32) + part[:, 2]).astype(F32) + part[:, 3]).astype(F32)
        nk = min(bk, s - k0)
        dbias_part[:, k0:k0 + nk] = tot[:, :nk]
    dq = to_bf16(dq_slab.sum(0, dtype=F32)) if key_blocks > 1 else to_bf16(dq_slab[0])
    dbias = dbias_part.reshape(b, h, s).sum(1, dtype=F32)
    return (dq.reshape(b, h, s, d), dk.reshape(b, h, s, d), dv.reshape(b, h, s, d), dbias)


BWD_BF16_CASES = {
    "s64_d128": (2, 2, 64, 128, [64, 37]),  # the training shape's tiling: one CTA per (b, h)
    "ragged_s100_d64": (2, 1, 100, 64, [100, 63]),  # 2 key blocks, 2 query tiles, dq slabs
    "fully_masked_row": (2, 1, 64, 64, [0, 17]),
    "key_blocks_d192": (2, 1, 80, 192, [80, 45]),  # BK = 32 (the 4-chunk swizzle), 3 key blocks
    "s40_d256": (1, 2, 40, 256, [33]),
}


@pytest.mark.parametrize("case", sorted(BWD_BF16_CASES))
def test_emulated_bwd_bf16_kernel_matches_twin_and_pallas(case):
    import jax

    from ultrafnd_git_tpu.kernels.flash_attention import flash_attention as jax_flash

    b, h, s, d, lengths = BWD_BF16_CASES[case]
    rng = np.random.default_rng(len(case) + d + s)
    q, k, v, do = (to_bf16(rng.standard_normal((b, h, s, d))) for _ in range(4))
    mask = (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(F32)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    tbias = fa.padding_bias(torch.from_numpy(mask), torch.bfloat16)
    out, lse = fa.reference_attention_bf16(tq, tk, tv, tbias)
    got = emulate_bwd_bf16(q, k, v, tbias.float().numpy().reshape(b, s), out.float().numpy(),
                           lse.numpy(), do)
    twin = [x.float().numpy() for x in fa.attention_bwd_reference_bf16(tq, tk, tv, tbias, out, lse, tdo)]
    twin[3] = twin[3].reshape(b, s)
    jbias = jax_padding_bias(jnp.asarray(mask), jnp.bfloat16)
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, backend="interpret", mm_dtype=jnp.bfloat16),
                     *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jbias)
    pallas = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jnp.bfloat16))]
    pallas[3] = pallas[3].reshape(b, s)
    for ref in (twin, pallas):
        for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
            assert np.isfinite(a).all(), name
            assert np.abs(a - r).max() <= 8e-3 * np.abs(r).max(), (name, np.abs(a - r).max())


def test_bwd_bf16_transposed_fragments_are_the_products():
    """ldmatrix.trans of a query-major (BQ, BK) tile gives P^T's A fragment,
    ldmatrix.trans of a row-major (rows, D) tile gives the B fragment whose
    reduction index is the row: one k16 step is exactly P^T dO; and dS's A
    fragment by ldmatrix with K's B fragment by ldmatrix.trans is dS K."""
    rng = np.random.default_rng(0)
    for bk in (64, 32):
        P = rng.integers(-8, 8, size=(16, bk)).astype(F32)  # exact in bf16: 16 queries x BK keys
        dO = rng.integers(-8, 8, size=(16, 64)).astype(F32)
        K = rng.integers(-8, 8, size=(bk, 64)).astype(F32)
        ps, dos, ks = (stage_b(x[None], 0, x.shape[0]) for x in (P, dO, K))
        for km in range(0, bk, 16):
            pa = ldsm_x4(ps, swzb(LR + 8 * (LM >> 1), km + 8 * (LM & 1), bk), trans=True)[0]
            for n2 in range(4):
                bfr = ldsm_x4(dos, swzb(LR + 8 * (LM & 1), 16 * n2 + 8 * (LM >> 1), 64), trans=True)[0]
                for half in range(2):
                    got = mma16(np.zeros((32, 4), F32), pa, bfr[:, 2 * half:2 * half + 2])
                    want = P[:, km:km + 16].T @ dO[:, 16 * n2 + 8 * half:16 * n2 + 8 * half + 8]
                    np.testing.assert_array_equal(got, np.stack(
                        [want[G, 2 * T], want[G, 2 * T + 1], want[G + 8, 2 * T], want[G + 8, 2 * T + 1]], -1))
        for j in range(bk // 16):
            sa = ldsm_x4(ps, swzb(LR + 8 * (LM & 1), 16 * j + 8 * (LM >> 1), bk))[0]
            bfr = ldsm_x4(ks, swzb(16 * j + LR + 8 * (LM & 1), 8 * (LM >> 1), 64), trans=True)[0]
            got = mma16(np.zeros((32, 4), F32), sa, bfr[:, 0:2])
            want = P[:, 16 * j:16 * j + 16] @ K[16 * j:16 * j + 16, 0:8]
            np.testing.assert_array_equal(got, np.stack(
                [want[G, 2 * T], want[G, 2 * T + 1], want[G + 8, 2 * T], want[G + 8, 2 * T + 1]], -1))


def _bwd_bf16_accesses(d):
    """Every shared-memory access of the bf16 backward at head width d:
    (name, 16-byte chunk of each of the 8 lanes of one phase) for ldmatrix
    and cp.async, and (name, 4-byte word of each of the 32 lanes) for the
    P and dS stores."""
    bk, nt_a, kg, npart, nt_c, nch = cfg_bwd_bf16(d)
    for w in range(BWD_WARPS):
        a_m0, a_n0 = (w >> 1) * 16, (w & 1) * (bk // 2)
        c_m0, c_n0 = (w % kg) * 16, (w // kg) * (d // npart)
        e_n0 = (w & 1) * (d // 2)
        mats = []
        for kk in range(0, d, 16):
            mats.append((f"Q/dO w{w} kk{kk}", swzb(a_m0 + LR + 8 * (LM & 1), kk + 8 * (LM >> 1), d)))
            for n2 in range(nt_a // 2):
                mats.append((f"K/V w{w} kk{kk} n{n2}",
                             swzb(a_n0 + 16 * n2 + LR + 8 * (LM >> 1), kk + 8 * (LM & 1), d)))
        for kq in range(0, BWD_BQ, 16):
            mats.append((f"P^T/dS^T w{w} kq{kq}", swzb(kq + LR + 8 * (LM >> 1), c_m0 + 8 * (LM & 1), bk)))
            for n2 in range(nt_c // 2):
                mats.append((f"dO/Q trans w{w} kq{kq} n{n2}",
                             swzb(kq + LR + 8 * (LM & 1), c_n0 + 16 * n2 + 8 * (LM >> 1), d)))
        for j in range(bk // 16):
            mats.append((f"dS w{w} j{j}", swzb(a_m0 + LR + 8 * (LM & 1), 16 * j + 8 * (LM >> 1), bk)))
            for ch in range(nch):
                for n2 in range(2):
                    mats.append((f"K trans w{w} j{j} ch{ch} n{n2}", swzb(
                        16 * j + LR + 8 * (LM & 1), e_n0 + 32 * ch + 16 * n2 + 8 * (LM >> 1), d)))
        for name, addr in mats:
            yield from ((f"{name} m{i}", "chunks", addr[8 * i:8 * i + 8]) for i in range(4))
        for n in range(nt_a):
            for hh in range(2):
                yield (f"P/dS store w{w} n{n} h{hh}", "words",
                       swzb(a_m0 + G + 8 * hh, a_n0 + 8 * n + 2 * T, bk) // 2)
    c8 = d // 8
    for i0 in range(0, BWD_BQ * c8, 8):
        i = i0 + np.arange(8)
        yield f"stage i{i0}", "chunks", swzb(i // c8, (i % c8) * 8, d)


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_bwd_bf16_smem_accesses_are_free_of_bank_conflicts(d):
    seen = 0
    for name, unit, elems in _bwd_bf16_accesses(d):
        seen += 1
        if unit == "chunks":
            assert (elems % 8 == 0).all(), name  # 16-byte aligned rows
            assert len(set(((elems * 2 // 16) % 8).tolist())) == 8, name
        else:
            assert len(set(elems.tolist())) == 32 and len(set((elems % 32).tolist())) == 32, name
    assert seen


def test_bwd_bf16_emulation_mirrors_the_kernel_source():
    src = (CSRC / "flash_attention_bwd_bf16.cu").read_text()
    for needle in (
        "constexpr int kWarps = 8;", "constexpr int kBlockQ = 64;",
        "BK = D <= 128 ? 64 : 32;", "NT_A = BK / 16;", "KG = BK / 16;",
        "NPART = kWarps / KG;", "NT_C = D / (8 * NPART);", "NCH = D / 64;",
        "constexpr int kShift = W >= 64 ? 0 : 1, kMask = W >= 64 ? 7 : 3;",
        "return r * W + (((c >> 3) ^ ((r >> kShift) & kMask)) << 3) + (c & 7);",
        "const int a_m0 = (warp >> 1) * 16;", "const int a_n0 = (warp & 1) * (BK / 2);",
        "const int c_m0 = (warp % C::KG) * 16;", "const int c_n0 = (warp / C::KG) * (D / C::NPART);",
        "const int e_n0 = (warp & 1) * (D / 2);",
        "const int ar = a_m0 + lrow + 8 * (lmat & 1), ac = kk + 8 * (lmat >> 1);",
        "ldsm_x4(b, Ks + swz<D>(a_n0 + 16 * np + lrow + 8 * (lmat >> 1), kk + 8 * (lmat & 1)));",
        "ldsm_x4(b, Vs + swz<D>(a_n0 + 16 * np + lrow + 8 * (lmat >> 1), kk + 8 * (lmat & 1)));",
        "const int pr = kq + lrow + 8 * (lmat >> 1), pc = c_m0 + 8 * (lmat & 1);",
        "ldsm_x4_trans(pa, Ps + swz<BK>(pr, pc));", "ldsm_x4_trans(sa, dSs + swz<BK>(pr, pc));",
        "const int br = kq + lrow + 8 * (lmat & 1), bc = c_n0 + 16 * np + 8 * (lmat >> 1);",
        "ldsm_x4_trans(b, dOs + swz<D>(br, bc));", "ldsm_x4_trans(b, Qs + swz<D>(br, bc));",
        "ldsm_x4(sfrag[j], dSs + swz<BK>(a_m0 + lrow + 8 * (lmat & 1), 16 * j + 8 * (lmat >> 1)));",
        "ldsm_x4_trans(b, Ks + swz<D>(16 * j + lrow + 8 * (lmat & 1),",
        "e_n0 + 32 * ch + 16 * np + 8 * (lmat >> 1)));",
        "*reinterpret_cast<uint32_t*>(Ps + swz<BK>(r, c)) = pack(p[0], p[1]);",
        "*reinterpret_cast<uint32_t*>(dSs + swz<BK>(r, c)) = pack(ds[0], ds[1]);",
        "for (int off = 4; off < 32; off <<= 1) col[j] += __shfl_xor_sync(0xffffffffu, col[j], off);",
        "((part[tid] + part[BK + tid]) + part[2 * BK + tid]) + part[3 * BK + tid];",
        'asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n" : "=r"(d) : "f"(hi), "f"(lo));',
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
    ):
        assert needle in src, needle



# ---------------------------------------------------------------------------
# (e) The BERT rung's 3xTF32 GEMM (csrc/gemm_tf32x3.cu).

GEMM = CSRC / "gemm_tf32x3.cu"


def gemm_constants():
    src = GEMM.read_text()
    out = {}
    for name in ("kBM", "kBK", "kRowBytes", "kSwizzleMode", "kLbo", "kSbo", "kStepBytes",
                 "kStageBudget", "kKahanRows"):
        m = re.search(rf"constexpr (?:uint32_t|int) {name} = (\d+);", src)
        assert m, name
        out[name] = int(m.group(1))
    maps = set(re.findall(r"CU_TENSOR_MAP_SWIZZLE_(\d+)B", src))
    assert len(maps) == 1, maps
    out["map_bits"] = MAP_BITS[int(maps.pop())]
    out["widths"] = [int(v) for v in re.search(
        r"constexpr int kShapeBN\[kShapes\] = \{([\d, ]+)\};", src).group(1).split(",")]
    return out


def emulate_gemm(x, w, b, kahan=False, stage=32):
    """The kernel's sums on (M, K) x and (N, K) w, f32: per k8 step the
    three terms as the tensor cores read them (hi TF32, lo its top 19 bits),
    summed from zero over a stage (each stage's sum exact, then rounded to
    f32: the tensor cores keep more bits than f32 inside a stage) and the
    stages added in f32; with `kahan` a k8 step's sum at a time,
    compensated. + b."""
    (xh, xl), (wh, wl) = split(x), split(w)
    step = 8 if kahan else stage
    acc = np.zeros((x.shape[0], w.shape[0]), F32)
    comp = np.zeros_like(acc)
    for k0 in range(0, x.shape[1], step):
        s = slice(k0, k0 + step)
        part = (xl[:, s].astype(np.float64) @ wh[:, s].T + xh[:, s].astype(np.float64) @ wl[:, s].T
                + xh[:, s].astype(np.float64) @ wh[:, s].T).astype(F32)
        if kahan:
            yv = (part - comp).astype(F32)
            tv = (acc + yv).astype(F32)
            comp = ((tv - acc).astype(F32) - yv).astype(F32)
            acc = tv
        else:
            acc = (acc + part).astype(F32)
    return (acc + b).astype(F32)


def _gap(y, want):
    return float(np.abs(y.astype(np.float64) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def gemm_cases():
    """bert-base's q/k/v (K 768, N 2304) and output (K 3072, N 768) products
    at M = 256: x N(0, 1), W and b N(0, 0.02^2), and their f64 products."""
    rng = np.random.default_rng(23)
    cases = {}
    for m, k, n in ((256, 768, 2304), (256, 3072, 768)):
        x = rng.standard_normal((m, k)).astype(F32)
        w = (0.02 * rng.standard_normal((n, k))).astype(F32)
        b = (0.02 * rng.standard_normal(n)).astype(F32)
        cases[(m, k, n)] = (x, w, b, x.astype(np.float64) @ w.T.astype(np.float64) + b)
    return cases


def test_gemm_split_is_tf32_mma_split():
    """split_tf32's hi is the mirror's hi bit for bit; its lo is exact, and
    as the tensor cores read it (top 19 bits) it is the mirror's lo."""
    from ultrafnd_git_tpu_torch.kernels import gemm_tf32x3 as gk

    w = np.random.default_rng(1).standard_normal((300, 64)).astype(F32) * 0.02
    hi, lo = (t.numpy() for t in gk.split_tf32(torch.from_numpy(w)))
    mh, ml = split(w)
    np.testing.assert_array_equal(hi.view(np.uint32), mh.view(np.uint32))
    np.testing.assert_array_equal((lo.view(np.uint32) & np.uint32(0xFFFFE000)), ml.view(np.uint32))
    np.testing.assert_array_equal(hi + lo, w)


@pytest.mark.parametrize("kahan", [False, True], ids=["stage_sums", "kahan_k8"])
@pytest.mark.parametrize("mkn", [(256, 768, 2304), (256, 3072, 768)], ids=["qkv", "ffn_out"])
def test_gemm_three_terms_are_f32_accurate_and_one_tf32_term_is_not(gemm_cases, mkn, kahan):
    """The kernel's sums within 2e-6 of the f64 product's largest value; one
    TF32 term (hi x hi, summed in f32) at least 10x farther off, so the
    mirror tells the two apart."""
    x, w, b, want = gemm_cases[mkn]
    kc = gemm_constants()
    gap = _gap(emulate_gemm(x, w, b, kahan=kahan, stage=kc["kBK"]), want)
    xh, wh = split(x)[0], split(w)[0]
    one = _gap((xh @ wh.T + b).astype(F32), want)
    assert gap <= 2e-6, gap
    assert one >= 10 * gap, (one, gap)


def _x_image(x, r0, k0, kc):
    """The X tile of one stage as the tensor map writes it: rows [r0, r0 +
    kBM) and columns [k0, k0 + kBK) of x, 128-byte rows at the map's
    swizzle, rows past M zero; as f32 words."""
    rows, cols = kc["kBM"], kc["kBK"]
    img = np.zeros(rows * cols, F32)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    ok = r0 + r < x.shape[0]
    addr = swizzle(r * kc["kRowBytes"] + c * 4, kc["map_bits"])
    img[addr[ok] // 4] = x[(r0 + r)[ok], k0 + c[ok]]
    return img


def _load_x_words(c, w, kk, h, plus8):
    """The words each lane of warp w of consumer c reads for a fragment of
    k8 step kk (h: columns + 4; plus8: rows + 8), by the kernel's load_x."""
    r = 64 * c + 16 * w + G
    col = (((2 * kk + h) ^ (r & 7)) << 2) + T
    return (r + 8 * plus8) * 32 + col, r + 8 * plus8, 8 * kk + T + 4 * h


def test_gemm_a_fragments_read_the_x_tile_without_bank_conflicts():
    """Every A fragment load of both consumers, every k8 step of a stage:
    the element of X the m16n8k8 layout names (a0 (g, t), a1 (g + 8, t), a2
    (g, t + 4), a3 (g + 8, t + 4)), from the swizzled image, 32 distinct
    banks; rows past M read as zeros."""
    kc = gemm_constants()
    x = np.random.default_rng(2).standard_normal((200, 64)).astype(F32)
    for r0, k0 in ((0, 0), (128, 32)):  # the second tile is ragged: 72 rows of 128
        img = _x_image(x, r0, k0, kc)
        for c in range(2):
            for w in range(4):
                for kk in range(kc["kBK"] // 8):
                    for h in range(2):
                        for plus8 in range(2):
                            words, r, col = _load_x_words(c, w, kk, h, plus8)
                            want = np.where(r0 + r < 200, x[np.minimum(r0 + r, 199), k0 + col], 0)
                            np.testing.assert_array_equal(img[words], want)
                            assert not _conflicts(words, 1), (c, w, kk, h, plus8)


def desc_read_f32(img, desc, mn):
    """The (mn, 8) K-major f32 operand a wgmma .tf32 k8 step reads through
    `desc` from the image img (bytes / 4): 8-row groups SBO apart, rows of
    one swizzle span, 4 bytes a column."""
    start, sbo = (desc & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4
    bits = SWIZZLE_BITS[desc >> 62]
    i, k = np.arange(mn)[:, None], np.arange(8)[None, :]
    lin = start + (i // 8) * sbo + (i % 8) * (16 << bits) + k * 4
    return img[swizzle(lin, bits) // 4]


@pytest.mark.parametrize("bn", [128, 96, 64])
def test_gemm_w_descriptors_read_back_each_k8_step(bn):
    """W_hi's tile (bn rows x 32) as the map writes it at the slot after the
    X tile; the kernel's descriptor of each k8 step (start + kk kStepBytes,
    kLbo, kSbo, kSwizzleMode) reads W[:, 8 kk .. 8 kk + 7] exactly."""
    kc = gemm_constants()
    w = np.random.default_rng(bn).standard_normal((bn, 64)).astype(F32)
    x_bytes = kc["kBM"] * kc["kRowBytes"]
    img = np.zeros((x_bytes + bn * kc["kRowBytes"]) // 4, F32)
    r, c = np.meshgrid(np.arange(bn), np.arange(kc["kBK"]), indexing="ij")
    img[swizzle(x_bytes + r * kc["kRowBytes"] + c * 4, kc["map_bits"]) // 4] = w[r, 32 + c]
    assert x_bytes % 1024 == 0  # the W slot starts on a swizzle atom
    for kk in range(kc["kBK"] // 8):
        d = make_desc(x_bytes + kk * kc["kStepBytes"], kc["kLbo"], kc["kSbo"], kc["kSwizzleMode"])
        np.testing.assert_array_equal(desc_read_f32(img, d, bn), w[:, 32 + 8 * kk: 40 + 8 * kk])


@pytest.mark.parametrize("bn", [128, 96, 64])
def test_gemm_ring_fits_the_sm_and_its_slots_sit_on_atoms(bn):
    """Each tile width's ring (Cfg: the X tile and two W tiles a stage, as
    many stages as the budget holds) with the alignment slack and barriers
    inside the 232,448 bytes an SM gives a block; at least 4 stages; every
    slot 1 KB aligned; a consumer's registers hold the f32 sum, the tensor
    cores' sum, Kahan's and a k8 step's A fragments."""
    kc = gemm_constants()
    assert bn in kc["widths"]
    src = GEMM.read_text()
    assert "static constexpr size_t SMEM = 1024 + NS * STAGE + 16 * NS;" in src
    stage = kc["kBM"] * kc["kRowBytes"] + 2 * bn * kc["kRowBytes"]
    ns = kc["kStageBudget"] // stage
    assert ns >= 4 and 1024 + ns * stage + 16 * ns <= 232448
    assert stage % 1024 == 0 and (bn * kc["kRowBytes"]) % 1024 == 0
    consumer = int(re.search(r"kConsumerRegs = (\d+);", src).group(1))
    assert consumer >= 3 * bn // 2 + 8 + 24


def test_gemm_emulation_mirrors_the_kernel_source():
    src = GEMM.read_text()
    for needle in (
        '#include "tf32_mma.cuh"',
        "const int c0 = ((((2 * kk) ^ (r & 7))) << 2) + t;",
        "const int c1 = ((((2 * kk + 1) ^ (r & 7))) << 2) + t;",
        "split(row[c0], hi[0], lo[0]);", "split(row[8 * kBK + c0], hi[1], lo[1]);",
        "split(row[c1], hi[2], lo[2]);", "split(row[8 * kBK + c1], hi[3], lo[3]);",
        "const int row0 = 64 * c + 16 * warp + g;",
        "const uint64_t dh = desc(h_slot(s) + kk * kStepBytes);",
        "const uint64_t dl = desc(l_slot(s) + kk * kStepBytes);",
        "wgmma<BN>(tc, al, dh, kk % GROUP);", "wgmma<BN>(tc, ah, dl);", "wgmma<BN>(tc, ah, dh);",
        "constexpr int GROUP = KAHAN ? 1 : kBK / 8;", "acc[i] += tc[i];",
        "const float yv = tc[i] - comp[i];", "comp[i] = (tv - acc[i]) - yv;",
        "if (m <= kKahanRows) return kShapes;",
        "return x * 0.5f * (1.0f + erff(x * 0.70710678118654752440f));",
        "float v0 = acc[4 * i + 2 * h] + b.x, v1 = acc[4 * i + 2 * h + 1] + b.y;",
        "(uint64_t)(kSbo >> 4) << 32 | (uint64_t)kSwizzleMode << 62;",
        "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE", "CU_TENSOR_MAP_DATA_TYPE_FLOAT32",
        "const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows}, unit[2] = {1, 1};",
        "const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * BN;",
    ):
        assert needle in src, needle
    for n in (64, 96, 128):  # A from registers, no transpose immediates (.tf32 takes none)
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 " in src
    assert src.count(", p, 1, 1;\\n}\\n\"") == 3
