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
