"""PyTorch port, the raw-media host pipeline (`data/media.py` and the
augmentation helpers of `data/dataset.py`) against the JAX package's.

Host code copied line for line, so every comparison is exact
(`np.array_equal`, dict equality): decoded fixture frames (uint8 and the
float [0, 1] contract, the dummy clip and its failure count), waveforms
(WAV sidecar, a stub ffmpeg on PATH, silence, resampling), comments, dataset
items, the collate (uint8 and mixed) and augmented items drawn from the
same seed.
"""
import os
import stat
from pathlib import Path

import numpy as np
import pytest

from ultrafnd_git_tpu.data import dataset as jax_dataset
from ultrafnd_git_tpu.data import media as jax_media
from ultrafnd_git_tpu_torch.data import dataset as port_dataset
from ultrafnd_git_tpu_torch.data import media as port_media

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "tests" / "fixtures" / "fakesv_tiny"
VIDEOS = sorted((TINY / "videos").glob("*.avi"))
NO_MEDIA = 20  # a record of the fixture without a video


def _equal_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def datasets():
    return jax_media.RawMediaDataset(str(TINY)), port_media.RawMediaDataset(str(TINY))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, "float32"])
def test_video_frames_equal(dtype):
    for path in VIDEOS[:4]:
        ref = jax_media.load_video_frames(path, dtype=dtype)
        got = port_media.load_video_frames(path, dtype=dtype)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert ref.max() > 0  # decoded, not the dummy
    np.testing.assert_array_equal(port_media.frames_float01(got), jax_media.frames_float01(got))


def test_video_failure_gives_counted_dummy(tmp_path):
    calls = {"jax": 0, "port": 0}
    bad = tmp_path / "broken.mp4"
    bad.write_bytes(b"\x00" * 64)
    for path in (bad, tmp_path / "missing.mp4"):
        ref = jax_media.load_video_frames(path, on_failure=lambda: calls.update(jax=calls["jax"] + 1))
        got = port_media.load_video_frames(path,
                                           on_failure=lambda: calls.update(port=calls["port"] + 1))
        assert np.array_equal(got, ref) and got.shape == (30, 256, 256, 3) and not got.any()
    assert calls == {"jax": 2, "port": 2}


def test_audio_sidecar_resample_and_silence_equal(tmp_path):
    for path in VIDEOS[:3]:
        ref = jax_media.load_audio_waveform(path)
        got = port_media.load_audio_waveform(path)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    # a stereo int16 WAV at 44.1 kHz, longer than the 10 s cap: mono,
    # scaled, resampled by scipy and cut
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    wav = tmp_path / "stereo.wav"
    wavfile.write(str(wav), 44100, rng.integers(-30000, 30000, (44100 * 11, 2), dtype=np.int16))
    ref = jax_media.load_audio_waveform(wav)
    got = port_media.load_audio_waveform(wav)
    assert got.shape == (160000,) and np.array_equal(got, ref)
    sig = rng.standard_normal(4410).astype(np.float32)
    assert np.array_equal(port_media._resample_poly(sig, 44100, 16000),
                          jax_media._resample_poly(sig, 44100, 16000))
    missing = tmp_path / "missing.mp4"
    assert np.array_equal(port_media.load_audio_waveform(missing),
                          jax_media.load_audio_waveform(missing))


def test_audio_ffmpeg_rung_equal(tmp_path, monkeypatch):
    """A container without a sidecar goes through `ffmpeg` when one is on
    PATH (a stub printing s16le PCM here), else to silence."""
    sr = 16000
    stub = tmp_path / "bin" / "ffmpeg"
    stub.parent.mkdir()
    stub.write_text(
        "#!/bin/sh\n"
        "python3 -c \"import sys,numpy as np; "
        f"sys.stdout.buffer.write((np.arange({sr},dtype=np.int16)*3).tobytes())\"\n"
    )
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"\x00" * 64)
    monkeypatch.setenv("PATH", f"{stub.parent}:{os.environ['PATH']}")
    ref = jax_media.load_audio_waveform(clip, sr=sr)
    got = port_media.load_audio_waveform(clip, sr=sr)
    assert np.abs(got[:sr]).max() > 0.5 and np.array_equal(got, ref)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    ref = jax_media.load_audio_waveform(clip)
    got = port_media.load_audio_waveform(clip)
    assert not got.any() and np.array_equal(got, ref)


def test_comments_equal(tmp_path):
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "a.json").write_text('[{"content": "x"}, "y", {"no": 1}]', encoding="utf-8")
    (tmp_path / "d" / "._a.json").write_text('{"content": "dropped"}', encoding="utf-8")
    (tmp_path / "d" / "b.json").write_text("", encoding="utf-8")
    paths = [TINY / "video_comment" / n for n in ("douyin_0000.json", "corrupt.json")]
    for path in paths + [tmp_path / "d", tmp_path / "missing.json"]:
        assert port_media.load_comments(path) == jax_media.load_comments(path)
    assert port_media.load_comments(tmp_path / "d") == ["x", "y"]


def test_items_and_failures_equal(datasets):
    jds, pds = datasets
    assert len(pds) == len(jds)
    for i in (0, 3, NO_MEDIA):
        _equal_items(pds[i], jds[i])
    assert pds.decode_failures == jds.decode_failures == 1
    filt = port_media.RawMediaDataset(str(TINY), filter_existing=True)
    assert filt.indices == jax_media.RawMediaDataset(str(TINY), filter_existing=True).indices
    assert len(filt) == 8


def test_collate_equal(datasets):
    jds, pds = datasets
    items = [pds[0], pds[1], pds[NO_MEDIA]]
    got, ref = port_media.multimodal_collate(items), jax_media.multimodal_collate(items)
    _equal_items(got, ref)
    assert got["video_frames"].dtype == np.uint8 and got["audio_waveform"].shape == (3, 80000)
    # a float item promotes the batch to float32 [0, 1]; a short clip pads
    mixed = [items[0], dict(items[1], video_frames=port_media.frames_float01(
        items[1]["video_frames"][:7]))]
    got, ref = port_media.multimodal_collate(mixed), jax_media.multimodal_collate(mixed)
    _equal_items(got, ref)
    assert got["video_frames"].dtype == np.float32


@pytest.mark.parametrize("augment", [True, False])
def test_augmented_items_equal(augment):
    """The same seed draws the same flips, jitter, noise and title words."""
    jds = jax_media.AugmentedRawMediaDataset(jax_media.RawMediaDataset(str(TINY)), augment, seed=3)
    pds = port_media.AugmentedRawMediaDataset(port_media.RawMediaDataset(str(TINY)), augment,
                                              seed=3)
    for i in (0, 1, 2, NO_MEDIA, 0):
        _equal_items(pds[i], jds[i])


def test_dataset_augment_helpers_equal():
    rng = np.random.default_rng(0)
    clip = rng.integers(0, 256, (3, 8, 6, 3), dtype=np.uint8)
    audio = rng.standard_normal(100).astype(np.float32)
    J, P = jax_dataset.FakeSVRawDataset, port_dataset.FakeSVRawDataset
    for seed in range(8):
        for video in (clip, clip[0]):
            assert np.array_equal(P.augment_video(video, np.random.default_rng(seed)),
                                  J.augment_video(video, np.random.default_rng(seed)))
        assert np.array_equal(P.augment_audio(audio, np.random.default_rng(seed)),
                              J.augment_audio(audio, np.random.default_rng(seed)))
        for text in ("a b c d", "a b"):
            assert (P.augment_text(text, np.random.default_rng(seed))
                    == J.augment_text(text, np.random.default_rng(seed)))
