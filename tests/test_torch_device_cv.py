"""PyTorch port, the device CV stage (`kernels/preprocess.py`) on the CPU
against the JAX package's jitted stage.

Inputs: seeded uint8 clips of (2, 6, 64, 64, 3) (upsampled to the 256
raster) and (1, 4, 320, 320, 3) (downsampled: the antialiased weights),
and the first as float [0, 1] frames. Tolerances, and why:
  * gray raster 1e-4 of 255: the same weights, summed in another order;
  * block flow u, v within 1e-3 px: the SAD sums of the two packages
    differ in their last bits, and a near-tie that fell to another
    candidate would move a block by >= 0.5 px; the count of such flips is
    reported and must be 0;
  * flow_feat 1e-5: the 8-bin histogram weighs each grid cell 256, so one
    cell whose time-averaged angle crossed a bin edge would move the
    L2-normed feature by > 1e-3; 1e-5 holds only with no such crossing;
  * cuts 1e-6 (exact counts over the same bins; the density divides by the
    same constant), flow_mags 1e-5 of their largest, tamper 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.kernels import preprocess as jax_pre
from ultrafnd_git_tpu_torch.kernels import preprocess as port_pre

SHAPES = [(2, 6, 64, 64, 3), (1, 4, 320, 320, 3), "float01"]
STAGE_TOL = {"flow_feat": 1e-5, "cuts": 1e-6, "tamper": 1e-6}
FLOW_MAG_REL = 1e-5
FLOW_PX = 1e-3
jax_block_match = jax.jit(jax_pre.block_match_flow)


def _clip(shape):
    rng = np.random.default_rng(0)
    if shape == "float01":
        return rng.integers(0, 256, SHAPES[0], dtype=np.uint8).astype(np.float32) / 255.0
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module", params=SHAPES, ids=["64", "320", "float01"])
def case(request):
    """(clip, JAX stage output, port stage output) of one input."""
    clip = _clip(request.param)
    return (clip, jax_pre.DeviceCVStage(flow_dim=256)(clip),
            port_pre.DeviceCVStage(flow_dim=256, device="cpu")(clip))


def test_stage_matches_jax(case):
    _, ref, got = case
    assert got.keys() == ref.keys()
    for key, tol in STAGE_TOL.items():
        assert got[key].shape == ref[key].shape and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], ref[key], atol=tol, rtol=0, err_msg=key)
    scale = float(np.abs(ref["flow_mags"]).max())
    np.testing.assert_allclose(got["flow_mags"], ref["flow_mags"], atol=FLOW_MAG_REL * scale,
                               rtol=0)
    assert np.isfinite(got["flow_feat"]).all() and got["cuts"].max() > 0


def test_gray_and_block_flow_match_jax(case):
    clip = case[0]
    scale = 255.0 if clip.dtype != np.uint8 else 1.0
    ref_g = np.asarray(jax_pre.gray_resize(jnp.asarray(clip))) * scale
    got_g = port_pre.gray_resize(torch.from_numpy(clip)).numpy() * scale
    np.testing.assert_allclose(got_g, ref_g, atol=1e-4 * 255, rtol=0)
    half = np.array(jax_pre._pyr_down(jnp.asarray(ref_g)))
    np.testing.assert_allclose(port_pre._pyr_down(torch.from_numpy(ref_g)).numpy(), half,
                               atol=1e-4, rtol=0)
    b, t = half.shape[:2]
    g0 = half[:, :-1].reshape(b * (t - 1), 128, 128)
    g1 = half[:, 1:].reshape(b * (t - 1), 128, 128)
    ju, jv = (np.asarray(x) for x in jax_block_match(jnp.asarray(g0), jnp.asarray(g1)))
    pu, pv = (x.numpy() for x in port_pre.block_match_flow(torch.from_numpy(g0),
                                                           torch.from_numpy(g1)))
    flips = int((np.abs(pu - ju) > 0.25).sum() + (np.abs(pv - jv) > 0.25).sum())
    assert flips == 0, f"{flips} block displacements fell to another candidate"
    np.testing.assert_allclose(pu, ju, atol=FLOW_PX, rtol=0)
    np.testing.assert_allclose(pv, jv, atol=FLOW_PX, rtol=0)


def test_pooled_stats_and_cuts_match_jax():
    rng = np.random.default_rng(5)
    mag = rng.uniform(0, 8, (2, 5, 16, 16)).astype(np.float32)
    ang = rng.uniform(0, 1, (2, 5, 16, 16)).astype(np.float32)
    for dim in (256, 64):
        got = port_pre.flow_stats(torch.from_numpy(mag), torch.from_numpy(ang), dim=dim,
                                  hist_scale=256.0).numpy()
        for i in range(2):
            ref = np.asarray(jax_pre.flow_stats(jnp.asarray(mag[i]), jnp.asarray(ang[i]), dim=dim,
                                                hist_scale=256.0))
            np.testing.assert_allclose(got[i], ref, atol=1e-6, rtol=0)
    gray = rng.uniform(0, 255, (6, 64, 64)).astype(np.float32)
    np.testing.assert_allclose(port_pre.density_histograms(torch.from_numpy(gray)).numpy(),
                               np.asarray(jax_pre.density_histograms(jnp.asarray(gray))),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(port_pre.cut_scores_device(torch.from_numpy(gray)).numpy(),
                               np.asarray(jax_pre.cut_scores_device(jnp.asarray(gray))),
                               atol=1e-6, rtol=0)
    assert port_pre._segment_bounds(3, 3) == jax_pre._segment_bounds(3, 3)


def test_static_clip_has_zero_flow_and_tamper():
    rng = np.random.default_rng(2)
    clip = np.tile(rng.integers(0, 256, (1, 1, 64, 64, 3), dtype=np.uint8), (1, 5, 1, 1, 1))
    out = port_pre.DeviceCVStage(device="cpu")(clip)
    assert float(out["flow_mags"].max()) == 0.0
    assert float(out["cuts"].max()) == 0.0
    assert float(out["tamper"][0]) == 0.0


def test_cpu_stage_is_deterministic_at_any_thread_count():
    """The CPU stage is the reference the card's is held to: over two calls
    and at 1, 2 and the default number of threads its cues are identical."""
    rng = np.random.default_rng(12)
    base = np.kron(rng.integers(0, 256, (2, 48, 48, 3), dtype=np.uint8),
                   np.ones((1, 8, 8, 1), np.uint8))
    clip = np.stack([base[:, 4 * t : 4 * t + 256, 64 - 2 * t : 320 - 2 * t]
                     for t in range(4)], axis=1)  # (2, 4, 256, 256, 3), moving (-4, +2)
    stage = port_pre.DeviceCVStage(device="cpu")
    ref = stage(clip)
    threads = torch.get_num_threads()
    try:
        for n in (threads, 1, 2):
            torch.set_num_threads(n)
            out = stage(clip)
            for k in ref:
                assert np.array_equal(out[k], ref[k]), (k, n)
    finally:
        torch.set_num_threads(threads)
    assert float(ref["flow_mags"].max()) > 0


def test_block_match_recovers_translation():
    """Content moved up 3 px and left 2 px: v = -3, u = -2."""
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 255, (300, 300)).astype(np.float32)
    g0 = torch.from_numpy(base[20:148, 20:148][None].copy())
    g1 = torch.from_numpy(base[23:151, 22:150][None].copy())
    u, v = port_pre.block_match_flow(g0, g1)
    inner = (0, slice(2, -2), slice(2, -2))
    assert abs(float(v[inner].median()) + 3.0) < 0.3
    assert abs(float(u[inner].median()) + 2.0) < 0.3


def test_host_gray_matches_device_gray():
    """The host gray (a third of the upload) is cvtColor's of each frame,
    and the stage on it stays within cvtColor's uint8 rounding of the
    stage on RGB (the JAX suite's bounds)."""
    cv2 = pytest.importorskip("cv2")
    from ultrafnd_git_tpu_torch.training.pipeline_v1 import BatchFeatureExtractor

    rng = np.random.default_rng(11)
    base = np.kron(rng.integers(40, 216, (12, 12, 3)), np.ones((8, 8, 1))).astype(np.uint8)
    clips = np.stack([
        np.stack([base[2 * t : 2 * t + 64, 2 * t : 2 * t + 64] for t in range(6)]),
        np.stack([base[10 - t : 74 - t, 4:68] for t in range(6)]),
    ])  # (2, 6, 64, 64, 3), 8-px blocks moving
    gray = BatchFeatureExtractor._gray_host(clips)
    assert gray.dtype == np.uint8 and gray.shape == clips.shape[:4]
    assert np.array_equal(gray[1, 3], cv2.cvtColor(clips[1, 3], cv2.COLOR_RGB2GRAY))
    stage = port_pre.DeviceCVStage(flow_dim=128, device="cpu")
    out_rgb, out_gray = stage(clips), stage(gray)
    np.testing.assert_allclose(out_gray["cuts"], out_rgb["cuts"], atol=5e-3, rtol=5e-2)
    np.testing.assert_allclose(out_gray["flow_feat"], out_rgb["flow_feat"], atol=1e-2)
    np.testing.assert_allclose(out_gray["tamper"], out_rgb["tamper"], atol=5e-2)
    pending = stage.dispatch(gray)  # dispatch hands back tensors on the stage's device
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in pending.values())
