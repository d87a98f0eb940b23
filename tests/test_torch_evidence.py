"""PyTorch port: the evidence scorers and the align MLP against the JAX
package's (`models/affective.py`, `models/semantic.py`,
`models/temporal.py`), on the offline rungs (ULTRAFND_DISABLE_HF=1).

Tolerances: the host scorers (lexicon probabilities, emotion intensity,
arousal, valence, semantic gap) 1e-6; the SemanticProjector and the align
MLP with the JAX params carried across 1e-5.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.models import affective as jax_aff
from ultrafnd_git_tpu.models import semantic as jax_sem
from ultrafnd_git_tpu.models.temporal import TemporalSyncNet as JaxSyncNet
from ultrafnd_git_tpu_torch.models import affective as port_aff
from ultrafnd_git_tpu_torch.models import semantic as port_sem
from ultrafnd_git_tpu_torch.models.temporal import TemporalSyncNet
from ultrafnd_git_tpu_torch.utils.transfer import align_state_dict, semantic_projector_state_dict

REPO = Path(__file__).resolve().parents[1]
HOST = dict(atol=1e-6, rtol=0)
DEVICE = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def records():
    path = REPO / "tests" / "fixtures" / "fakesv_hard" / "data_complete.json"
    return [json.loads(ln) for ln in path.read_text("utf-8").splitlines() if ln.strip()]


@pytest.fixture(scope="module")
def texts(records):
    extra = ["", "恐惧 愤怒 真相", "外星人警告危险假", "辟谣 科学 证据 研究", "普通 内容"]
    return [(r.get("title") or "") + " " + (r.get("ocr") or "") for r in records] + extra


def test_lexicon_is_the_jax_lexicon():
    assert port_aff.EMO_LEXICON == jax_aff.EMO_LEXICON


def test_lexicon_probs_match_jax(texts):
    ours, ref = port_aff.lexicon_probs_batch(texts), jax_aff.lexicon_probs_batch(texts)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **HOST)
    assert (ours.sum(axis=1) <= 1.0 + 1e-6).all()


def _waves(n):
    rng = np.random.default_rng(3)
    waves = []
    for i in range(n):
        if i % 7 == 0:
            waves.append(None)
        elif i % 7 == 1:
            waves.append(np.zeros(0, np.float32))
        else:
            length = int(rng.integers(200, 40000))
            t = np.arange(length) / 16000.0
            waves.append((rng.uniform(0.05, 0.8) * np.sin(2 * np.pi * rng.uniform(80, 4000) * t)
                          + 0.05 * rng.standard_normal(length)).astype(np.float32))
    return waves


@pytest.mark.parametrize("audio", [False, True], ids=["text_only", "with_audio"])
def test_analyze_batch_matches_jax(texts, audio):
    waves = _waves(len(texts)) if audio else None
    ours = port_aff.AffectiveForensics.from_config().analyze_batch(texts, waves)
    ref = jax_aff.AffectiveForensics.from_config().analyze_batch(texts, waves)
    assert set(ours) == set(ref) == {"probs", "intensity", "arousal", "valence"}
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        np.testing.assert_allclose(ours[key], ref[key], err_msg=key, **HOST)
    if audio:
        assert np.unique(ours["arousal"]).size > 10


def test_analyze_and_intensity_of_one_sample_match_jax():
    wave = _waves(3)[2]
    ours, ref = port_aff.AffectiveForensics(), jax_aff.AffectiveForensics()
    for text, audio in (("恐惧 外星人 警告", wave), ("辟谣 科学", None), (None, None)):
        a, b = ours.analyze(text, audio), ref.analyze(text, audio)
        assert a.keys() == b.keys() and a["probs"].keys() == b["probs"].keys()
        for k in ("intensity", "arousal", "valence"):
            assert abs(a[k] - b[k]) <= 1e-6, k
        for k in a["probs"]:
            assert abs(a["probs"][k] - b["probs"][k]) <= 1e-6, k
        assert abs(ours.get_emotion_intensity(text, audio)
                   - ref.get_emotion_intensity(text, audio)) <= 1e-6


@pytest.mark.parametrize("zeros_fallback", [False, True], ids=["hash_rung", "zeros_fallback"])
def test_gap_magnitude_matches_jax(records, zeros_fallback):
    titles = [r.get("title") or "" for r in records] + ["同一 文本", "", "外星"]
    ocrs = [r.get("ocr") or "" for r in records] + ["同一 文本", ""]  # one shorter: padded
    ours = port_sem.SemanticForgeryAnalyzer(
        port_sem.SemanticConfig(zeros_fallback=zeros_fallback)).gap_magnitude(titles, ocrs)
    ref = jax_sem.SemanticForgeryAnalyzer(
        jax_sem.SemanticConfig(zeros_fallback=zeros_fallback)).gap_magnitude(titles, ocrs)
    assert ours.dtype == ref.dtype and ours.shape == (len(titles),)
    np.testing.assert_allclose(ours, ref, **HOST)
    if not zeros_fallback:
        assert ours[len(records)] == 0.0  # identical title and OCR
        assert ours.std() > 0


def test_semantic_encoders_match_jax(texts):
    ours = port_sem.SemanticForgeryAnalyzer.from_config()
    ref = jax_sem.SemanticForgeryAnalyzer()
    np.testing.assert_array_equal(ours.encode_text(texts), ref.encode_text(texts))
    np.testing.assert_array_equal(ours.encode_image_like(texts[:9]), ref.encode_image_like(texts[:9]))
    assert ours.cfg == port_sem.SemanticConfig(**vars(ref.cfg))


@pytest.mark.parametrize("in_dim,proj_dim", [(512, 512), (768, 256)])
def test_semantic_projector_with_jax_params_matches_jax(in_dim, proj_dim):
    rng = np.random.default_rng(in_dim)
    txt, img = (rng.standard_normal((24, in_dim)).astype(np.float32) for _ in range(2))
    module = jax_sem.SemanticProjector(proj_dim=proj_dim, dropout=0.3)
    variables = module.init(jax.random.PRNGKey(7), jnp.asarray(txt), jnp.asarray(img))
    ref = module.apply(variables, jnp.asarray(txt), jnp.asarray(img), deterministic=True)
    proj = port_sem.SemanticProjector(in_dim, proj_dim, dropout=0.3).eval()
    sd = semantic_projector_state_dict(jax.device_get(variables))
    assert set(sd) == set(proj.state_dict())
    proj.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        ours = proj(torch.from_numpy(txt), torch.from_numpy(img))
    assert set(ours) == set(ref) == {"semantic_text", "semantic_image", "semantic_gap"}
    for key in ref:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), err_msg=key, **DEVICE)
    # training mode: a generator turns the branches' dropout on
    with torch.no_grad():
        out = proj(torch.from_numpy(txt), torch.from_numpy(img), torch.Generator().manual_seed(0))
    assert not torch.allclose(out["semantic_text"], ours["semantic_text"])


@pytest.fixture(scope="module")
def align_inputs():
    rng = np.random.default_rng(11)
    t = rng.standard_normal((37, 768)).astype(np.float32)
    return t / np.linalg.norm(t, axis=1, keepdims=True), rng.standard_normal((37, 512)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 42])
def test_sync_net_with_jax_params_matches_jax(align_inputs, seed):
    t, v = align_inputs
    ref = JaxSyncNet(768, 256, seed=seed)
    ours = TemporalSyncNet(768, 256, state_dict=align_state_dict(jax.device_get(ref.params)),
                           device="cpu")
    np.testing.assert_allclose(ours.align_batch(t, v), ref.align_batch(t, v), **DEVICE)
    (u, u_tt), (r, r_tt) = ours.align_batch_pair(t, v), ref.align_batch_pair(t, v)
    np.testing.assert_allclose(u, r, **DEVICE)
    np.testing.assert_allclose(u_tt, r_tt, **DEVICE)
    # one 2N-row pass equals the two N-row passes (the MLP works row by row)
    np.testing.assert_allclose(u, ours.align_batch(t, v), atol=1e-6, rtol=0)
    np.testing.assert_allclose(u_tt, ours.align_batch(t, t), atol=1e-6, rtol=0)


def test_sync_net_own_draw_is_seeded_with_the_jax_distribution(align_inputs):
    t, v = align_inputs
    a, b, c = (TemporalSyncNet(768, 256, seed=s, device="cpu") for s in (5, 5, 6))
    np.testing.assert_array_equal(a.align_batch(t, v), b.align_batch(t, v))
    assert not np.allclose(a.align_batch(t, v), c.align_batch(t, v))
    jax_params = JaxSyncNet(768, 256, seed=5).params["params"]
    for name, mod in (("proj_in", a.module.proj_in), ("proj_out", a.module.proj_out)):
        bound = 1.0 / np.sqrt(mod.in_features)
        for p in (mod.weight, mod.bias):
            x = p.detach().numpy()
            assert np.abs(x).max() <= bound and np.abs(x).max() > 0.95 * bound
            assert abs(float(x.mean())) < 4 * bound / np.sqrt(3 * x.size)  # 4 sigma
        ref_kernel = np.asarray(jax_params[name]["kernel"])
        ref_bias = np.asarray(jax_params[name]["bias"])
        # the same distribution: U(+-1/sqrt(fan_in)) weights and biases alike
        assert np.isclose(mod.weight.detach().numpy().std(), ref_kernel.std(), rtol=0.05)
        assert np.abs(ref_bias).max() <= bound and np.abs(ref_bias).max() > 0.9 * bound


def test_sync_net_pads_a_narrow_visual_input(align_inputs):
    t, v = align_inputs
    ref = JaxSyncNet(768, 256, seed=1)
    ours = TemporalSyncNet(768, 256, state_dict=align_state_dict(jax.device_get(ref.params)),
                           device="cpu")
    np.testing.assert_allclose(ours.align_batch(t, v[:, :300]), ref.align_batch(t, v[:, :300]),
                               **DEVICE)
    np.testing.assert_allclose(ours.align_batch(t, np.pad(v, ((0, 0), (0, 400)))),
                               ref.align_batch(t, np.pad(v, ((0, 0), (0, 400)))), **DEVICE)
