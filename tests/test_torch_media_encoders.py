"""PyTorch port, the waveform and frame rungs of the media encoders
(`models/audio.py`, `models/visual.py`, `models/chronos.py` and the host
helpers of `models/temporal.py`) against the JAX package's.

Each port module is the JAX module's numpy / cv2 code, run here in the
same process on the same inputs, so every comparison is exact
(`np.array_equal`, float equality), the cv2 calls (Farneback flow, the JPEG
re-encode of ELA, Sobel, cvtColor, resize) included: both packages make the
same calls into the one cv2 build. Inputs: the fixture's decoded clips
(the first 6 frames, to keep the flow passes short) and waveforms (its WAV
sidecars, seeded noise, a stereo clip at 44.1 kHz, silence, a string).
"""
from pathlib import Path

import numpy as np
import pytest

from ultrafnd_git_tpu.models import audio as jax_audio
from ultrafnd_git_tpu.models import chronos as jax_chronos
from ultrafnd_git_tpu.models import visual as jax_visual
from ultrafnd_git_tpu.models.temporal import TemporalSyncNet as JaxSync
from ultrafnd_git_tpu.ops import hashing as jax_hashing
from ultrafnd_git_tpu_torch.data import media as port_media
from ultrafnd_git_tpu_torch.models import audio as port_audio
from ultrafnd_git_tpu_torch.models import chronos as port_chronos
from ultrafnd_git_tpu_torch.models import visual as port_visual
from ultrafnd_git_tpu_torch.models.temporal import TemporalSyncNet as PortSync
from ultrafnd_git_tpu_torch.ops import hashing as port_hashing

REPO = Path(__file__).resolve().parents[1]
VIDEOS = sorted((REPO / "tests" / "fixtures" / "fakesv_tiny" / "videos").glob("*.avi"))
FRAMES = 6


@pytest.fixture(autouse=True)
def _same_salts():
    """Strings hash under each package's process-wide salt, which a module run
    before this one in the same process may have left set in only one of them:
    give both the unsalted basis for each test, then put back what was there."""
    prev = port_hashing.get_hash_salt(), jax_hashing.get_hash_salt()
    port_hashing.set_hash_salt("")
    jax_hashing.set_hash_salt("")
    yield
    port_hashing.set_hash_salt(prev[0])
    jax_hashing.set_hash_salt(prev[1])


@pytest.fixture(scope="module")
def clips():
    """Two fixture clips (6 frames, uint8), one as float [0, 1] frames and
    one as a list of CHW frames."""
    out = [port_media.load_video_frames(p)[:FRAMES] for p in VIDEOS[:2]]
    out.append(out[0].astype(np.float32) / 255.0)
    out.append([np.transpose(f, (2, 0, 1)) for f in out[1]])
    return out


@pytest.fixture(scope="module")
def waves():
    rng = np.random.default_rng(0)
    return [
        (port_media.load_audio_waveform(VIDEOS[0]), 16000),
        (rng.standard_normal(24000).astype(np.float32), 16000),
        (rng.standard_normal((2, 44100)).astype(np.float32), 44100),
        (np.zeros(16000, np.float32), 16000),
        (np.zeros(0, np.float32), 16000),
        (np.ones(100, np.float32), 8000),  # shorter than one STFT frame
    ]


def test_spectral_forensics_equal(waves):
    jax_enc, port_enc = jax_audio.SpectralForensics(dim=128), port_audio.SpectralForensics(128)
    assert not jax_enc.use_w2v2  # the hermetic ladder: no HF weights
    for w, sr in waves:
        assert np.array_equal(port_enc.extract(w, sr), jax_enc.extract(w, sr))
        assert np.array_equal(port_audio.ensure_mono_16k(w, sr)[0],
                              jax_audio.ensure_mono_16k(w, sr)[0])
    batch = [w for w, sr in waves if sr == 16000]
    got = port_enc.extract_waveform_batch(batch)
    assert got.shape == (len(batch), 128)
    assert np.array_equal(got, jax_enc.extract_waveform_batch(batch))
    texts = ["a b c", "", "外星人 警告"]
    assert np.array_equal(port_enc.extract("a b c"), jax_enc.extract("a b c"))
    assert np.array_equal(port_enc.extract_text_batch(texts), jax_enc.extract_text_batch(texts))
    wav = waves[1][0]
    assert np.array_equal(port_enc._stft_stats_fallback(wav), jax_enc._stft_stats_fallback(wav))


def test_mel_and_voice_clone_equal(waves):
    jmel, pmel = jax_audio.MelSpectrogramGenerator(), port_audio.MelSpectrogramGenerator()
    jvc, pvc = jax_audio.VoiceCloneDetector(), port_audio.VoiceCloneDetector()
    for w, sr in waves[:4]:
        for flatten in (True, False):
            assert np.array_equal(pmel.generate(w, sr, flatten), jmel.generate(w, sr, flatten))
        assert pvc.score(w, sr) == jvc.score(w, sr)
    assert pvc.score("some text") == jvc.score("some text")
    assert np.array_equal(port_audio.mel_filterbank(22050, 512, 40),
                          jax_audio.mel_filterbank(22050, 512, 40))


def test_optical_flow_equal(clips):
    """cv2's flow ladder (TV-L1 where cv2.optflow exists, else Farneback)
    and the pooled features, both packages on the same clips."""
    jflow, pflow = jax_visual.OpticalFlow3DCNN(dim=256), port_visual.OpticalFlow3DCNN(dim=256)
    assert pflow.use_tvl1 == jflow.use_tvl1
    for clip in clips:
        got, ref = pflow.extract(clip), jflow.extract(clip)
        assert got.shape == (256,) and np.array_equal(got, ref)
    assert np.array_equal(pflow.extract("a b"), jflow.extract("a b"))
    assert np.array_equal(pflow.extract(clips[0][:1]), jflow.extract(clips[0][:1]))  # one frame
    # the pooling of given fields (the no-cv2 difference rung's layout too)
    rng = np.random.default_rng(1)
    flows = [rng.standard_normal((32, 32, 2)).astype(np.float32) for _ in range(3)]
    assert np.array_equal(pflow.pool_flows(flows), jflow.pool_flows(flows))
    assert np.array_equal(pflow.pool_flows([]), jflow.pool_flows([]))


def test_forgery_and_face_warp_equal(clips):
    jdet, pdet = jax_visual.DeepForgeryDetector(dim=256), port_visual.DeepForgeryDetector(dim=256)
    jfw, pfw = jax_visual.FaceWarpAnalyzer(), port_visual.FaceWarpAnalyzer()
    rng = np.random.default_rng(2)
    single = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    for x in clips + [single]:
        assert np.array_equal(pdet.ela_lbp(x), jdet.ela_lbp(x))
        assert pfw.score(x) == jfw.score(x)
    assert np.array_equal(pdet.ela_lbp("t u"), jdet.ela_lbp("t u"))
    assert pfw.score("t u") == jfw.score("t u")
    assert np.array_equal(pdet.ela_map(single), jdet.ela_map(single))
    gray1 = rng.integers(0, 256, (40, 50, 1), dtype=np.uint8)
    for x in (single, gray1, gray1[..., 0]):
        assert np.array_equal(port_visual.ensure_gray(x), jax_visual.ensure_gray(x))


def test_chronos_equal(clips):
    jg, pg = jax_chronos.ChronosGuard.from_config(), port_chronos.ChronosGuard.from_config()
    assert (pg.feat_dim, pg.use_opencv) == (jg.feat_dim, jg.use_opencv) == (128, True)
    for clip in clips[:2]:
        assert np.array_equal(pg.extract_features(clip), jg.extract_features(clip))
        assert pg.temporal_tamper_score(clip) == jg.temporal_tamper_score(clip)
    gray = np.stack([port_visual.ensure_gray(f) for f in clips[1]])
    assert np.array_equal(port_chronos.cut_scores(gray), jax_chronos.cut_scores(gray))
    assert np.array_equal(pg.extract_features_batch(clips[:1]), jg.extract_features_batch(clips[:1]))
    cuts, mags = np.array([0.1, 0.3], np.float32), np.array([], np.float32)
    assert pg.tamper_score_from_cues(cuts, mags) == jg.tamper_score_from_cues(cuts, mags)
    # the |frame difference| rung (use_opencv off)
    jd, pd = jax_chronos.ChronosGuard(use_opencv=False), port_chronos.ChronosGuard(use_opencv=False)
    assert np.array_equal(pd.extract_features(clips[0]), jd.extract_features(clips[0]))


def test_temporal_host_helpers_equal():
    rng = np.random.default_rng(3)
    env = rng.standard_normal(4000).astype(np.float32)
    mouth = np.roll(env, 160)
    for args, kw in (((env, mouth), {}), ((env, mouth[:90]), {"sr": 16000.0, "fps": 30.0}),
                     ((env[:3], mouth[:3]), {})):
        assert PortSync.estimate_av_lag(*args, **kw) == JaxSync.estimate_av_lag(*args, **kw)
        assert (port_chronos.ChronosGuard.estimate_av_lag(*args, **kw)
                == jax_chronos.ChronosGuard.estimate_av_lag(*args, **kw))
    for a, v in ((80000, 79000), (0, 0), (5, -3)):
        assert PortSync.delay_score(a, v) == JaxSync.delay_score(a, v)
