"""Raw-media host pipeline: video, audio and comment decode, and the
fixed-shape collate (counterpart of `data/media.py`).

Host code, line for line the JAX module's, so each function returns what
its original returns on the same inputs:

  * `load_video_frames`: cv2 decode of <= 30 frames, BGR -> RGB, bilinear
    resize to 256 x 256, last-frame pad, uint8 [0, 255] (float32 [0, 1]
    on request); the all-zero dummy clip, with `on_failure` called once,
    when cv2 is absent or the file does not decode;
  * `load_audio_waveform`: mono 16 kHz, zero-padded to 5 s and cut at 10 s;
    the file itself if it is a WAV, else a `<stem>.wav` sidecar (scipy),
    else an ffmpeg subprocess when `ffmpeg` is on PATH, else silence;
  * `load_comments`: a comment JSON file or a directory of them, tolerant
    of dicts, lists, corrupt or empty files and `._` droppings;
  * `RawMediaDataset` (`decode_failures`, `filter_existing`),
    `multimodal_collate` (video (B, 30, 256, 256, 3) in the items' dtype,
    a mixed batch promoted to float32 [0, 1]; audio (B, 80000)) and
    `AugmentedRawMediaDataset` (flip p = .5, brightness / contrast jitter,
    audio noise p = .3, a title word p = .1, from one numpy generator).

Labels follow `data.dataset.label_of` (the v2 convention). Frames stay
uint8 to the device stage (`kernels/preprocess.py`), four times fewer
bytes to upload than float32.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ultrafnd_git_tpu_torch.data.dataset import FakeSVRawDataset

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

NUM_FRAMES = 30
FRAME_SIZE = (256, 256)
SR = 16000
MIN_AUDIO_S = 5
MAX_AUDIO_S = 10
AUDIO_LEN = SR * MIN_AUDIO_S  # collate length, 80000 (ref :520-521)


# ----------------------------------------------------------------------
# Decoders
# ----------------------------------------------------------------------

def load_video_frames(
    video_path: Path | str,
    num_frames: int = NUM_FRAMES,
    size=FRAME_SIZE,
    dtype=np.uint8,
    on_failure=None,
) -> np.ndarray:
    """Decode -> (num_frames, H, W, 3) uint8 [0, 255]; dummy on failure.

    Pass `dtype=np.float32` for the reference's float [0, 1] contract
    (ref :313 divides at decode); the default stays in the codec's native
    uint8 — see the module docstring for why. `on_failure` is invoked
    once whenever the dummy clip is returned, so callers can count real
    decode failures (an all-zero clip is indistinguishable by content).
    """
    dummy = np.zeros((num_frames, size[0], size[1], 3), dtype=dtype)

    def _fail() -> np.ndarray:
        if on_failure is not None:
            on_failure()
        return dummy

    if not _HAS_CV2:
        return _fail()
    try:
        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            return _fail()
        frames: List[np.ndarray] = []
        while len(frames) < num_frames:
            ok, frame = cap.read()
            if not ok:
                break
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            rgb = cv2.resize(rgb, size, interpolation=cv2.INTER_LINEAR)
            frames.append(rgb)
        cap.release()
        if not frames:
            return _fail()
        while len(frames) < num_frames:  # last-frame pad (ref :329-333)
            frames.append(frames[-1])
        out = np.stack(frames[:num_frames])
        if np.issubdtype(np.dtype(dtype), np.floating):
            # np.dtype(...).type works for classes, instances and strings
            # (a bare `dtype(255.0)` call would raise for the latter two
            # and silently return the dummy via the except below)
            return out.astype(dtype) / np.dtype(dtype).type(255.0)
        return out
    except Exception:
        return _fail()


def frames_float01(frames: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] or float frames -> float32 [0, 1] (reference contract)."""
    arr = np.asarray(frames)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    return arr.astype(np.float32)


def _resample_poly(wave: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return wave
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(wave, sr_out // g, sr_in // g).astype(np.float32)


def load_audio_waveform(
    media_path: Path | str,
    sr: int = SR,
    min_s: int = MIN_AUDIO_S,
    max_s: int = MAX_AUDIO_S,
) -> np.ndarray:
    """Mono waveform at `sr`, zero-padded to >= min_s, truncated to max_s.

    Ladder (reference `src/training/run_train_eval.py:353-421`, whose
    order is torchaudio -> ffmpeg subprocess -> silence):
      1. the file itself if it is a WAV, else a `<stem>.wav` sidecar
         (direct parse, no demuxer needed),
      2. ffmpeg-subprocess demux of the container's audio track, gated on
         `shutil.which("ffmpeg")` — restores the reference's middle rung,
      3. silence.
    """
    silence = np.zeros(sr * min_s, dtype=np.float32)
    p = Path(media_path)

    def _finalize(wave: np.ndarray, sr_in: int) -> np.ndarray:
        # capture the SOURCE dtype before the stereo mean promotes to
        # float (a stereo int16 would otherwise skip normalization and
        # come out at +-32767 instead of +-1)
        src_dtype = wave.dtype
        if wave.ndim == 2:  # stereo -> mono
            wave = wave.mean(axis=1)
        if np.issubdtype(src_dtype, np.integer):
            wave = wave.astype(np.float32) / float(np.iinfo(src_dtype).max)
        wave = _resample_poly(wave.astype(np.float32), int(sr_in), sr)
        wave = wave[: sr * max_s]
        if wave.size < sr * min_s:
            wave = np.concatenate(
                [wave, np.zeros(sr * min_s - wave.size, np.float32)]
            )
        return wave.astype(np.float32)

    candidates = [p] if p.suffix.lower() == ".wav" else []
    candidates.append(p.with_suffix(".wav"))
    for cand in candidates:
        try:
            if not cand.exists() or cand.stat().st_size == 0:
                continue
            from scipy.io import wavfile

            sr_in, wave = wavfile.read(str(cand))
            return _finalize(np.asarray(wave), sr_in)
        except Exception:
            continue

    wave = _ffmpeg_decode_audio(p, sr)
    if wave is not None and wave.size:
        return _finalize(wave, sr)
    return silence


def _ffmpeg_decode_audio(path: Path, sr: int) -> "np.ndarray | None":
    """ffmpeg-subprocess rung (reference `run_train_eval.py:391-421`):
    demux + decode the audio track to mono 16-bit PCM on stdout. Returns
    None when ffmpeg is absent or decoding fails (ladder falls through
    to silence)."""
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None or not path.exists():
        return None
    try:
        proc = subprocess.run(
            [
                ffmpeg, "-v", "error", "-i", str(path),
                "-f", "s16le", "-acodec", "pcm_s16le",
                "-ac", "1", "-ar", str(sr), "pipe:1",
            ],
            capture_output=True,
            timeout=60,
        )
        if proc.returncode != 0 or not proc.stdout:
            return None
        return np.frombuffer(proc.stdout, dtype=np.int16)
    except Exception:
        return None


def load_comments(comment_path: Path | str) -> List[str]:
    """Tolerant comment loader: dir of JSON files or a single JSON file.

    Handles dict {content}, list of dicts/strings, corrupt/empty files and
    macOS `._` droppings (ref :432-476) by skipping silently.
    """
    p = Path(comment_path)
    files: List[Path] = []
    if p.is_dir():
        files = sorted(p.glob("*.json"))
    elif p.exists():
        files = [p]

    out: List[str] = []
    for f in files:
        if f.name.startswith("._"):
            continue
        try:
            if f.stat().st_size == 0:
                continue
            content = f.read_text(encoding="utf-8", errors="ignore").strip()
            if not content:
                continue
            data = json.loads(content)
        except Exception:
            continue
        if isinstance(data, dict):
            text = data.get("content", "")
            if isinstance(text, str) and text:
                out.append(text)
        elif isinstance(data, list):
            for item in data:
                if isinstance(item, dict):
                    text = item.get("content", "")
                    if isinstance(text, str) and text:
                        out.append(text)
                elif isinstance(item, str) and item.strip():
                    out.append(item.strip())
    return out


# ----------------------------------------------------------------------
# Dataset + collate
# ----------------------------------------------------------------------

class RawMediaDataset:
    """Raw-media FakeSV dataset: metadata + decoded frames/audio/comments.

    Layout (reference v1, ref :198-284): `data_root/data_complete.json`,
    `videos/<id>.mp4` (any cv2-readable container), optional `<id>.wav`
    audio sidecars, `video_comment/<id>.json` or `video_comment/<id>/`.
    """

    def __init__(
        self,
        data_root: str,
        filter_existing: bool = False,
        num_frames: int = NUM_FRAMES,
    ):
        self.root = Path(data_root)
        self.meta = FakeSVRawDataset(data_root)
        self.num_frames = num_frames
        self.video_dir = self.root / "videos"
        self.comment_dir = self.root / "video_comment"
        self.decode_failures = 0  # data-level fault counter (SURVEY §5.3)

        self.indices = list(range(len(self.meta)))
        if filter_existing:
            self.indices = [
                i
                for i in self.indices
                if self._video_path(self.meta.get_item(i)["id"]) is not None
            ]

    def _video_path(self, vid: str) -> Optional[Path]:
        for ext in (".mp4", ".avi", ".mkv", ".mov"):
            p = self.video_dir / f"{vid}{ext}"
            if p.exists():
                return p
        return None

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = self.meta.get_item(self.indices[i])
        vid = rec["id"]
        vp = self._video_path(vid)
        if vp is None:
            frames = np.zeros(
                (self.num_frames, *FRAME_SIZE, 3), dtype=np.uint8
            )
            audio = np.zeros(AUDIO_LEN, dtype=np.float32)
            self.decode_failures += 1
        else:
            def _count():
                self.decode_failures += 1

            frames = load_video_frames(
                vp, self.num_frames, on_failure=_count
            )
            audio = load_audio_waveform(vp)

        comments = list(rec["comments"])
        for cand in (
            self.comment_dir / f"{vid}.json",
            self.comment_dir / vid,
        ):
            extra = load_comments(cand)
            if extra:
                comments.extend(extra)
                break

        return {
            "video_id": vid,
            "video_frames": frames,
            "audio_waveform": audio,
            "text_data": {
                "title": rec["title"],
                "ocr": rec["ocr"],
                "comments": comments,
            },
            "label": rec["label"],
        }


def multimodal_collate(batch: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Fixed-shape batch: video [B,30,256,256,3], audio [B,80000].

    Frame dtype is preserved: uint8 items collate to a uint8 batch (the
    default decode contract), float items to float32. A mixed batch
    promotes to float32 [0, 1].
    """
    any_float = any(
        np.asarray(item["video_frames"]).dtype != np.uint8 for item in batch
    )
    frame_dtype = np.float32 if any_float else np.uint8

    videos, audios, texts, labels, ids = [], [], [], [], []
    for item in batch:
        frames = np.asarray(item["video_frames"])
        if frames.dtype != frame_dtype:
            frames = frames_float01(frames)  # uint8 row in a float batch
        t = frames.shape[0]
        if t < NUM_FRAMES:
            last = (
                frames[-1:]
                if t > 0
                else np.zeros((1, *FRAME_SIZE, 3), frame_dtype)
            )
            frames = np.concatenate(
                [frames, np.repeat(last, NUM_FRAMES - t, axis=0)], axis=0
            )
        videos.append(frames[:NUM_FRAMES])

        audio = np.asarray(item["audio_waveform"], dtype=np.float32).ravel()
        if audio.size < AUDIO_LEN:
            audio = np.concatenate(
                [audio, np.zeros(AUDIO_LEN - audio.size, np.float32)]
            )
        audios.append(audio[:AUDIO_LEN])

        texts.append(item["text_data"])
        labels.append(int(item["label"]))
        ids.append(item["video_id"])

    return {
        "video_frames": np.stack(videos),
        "audio_waveform": np.stack(audios),
        "text_data": texts,
        "label": np.asarray(labels, dtype=np.int64),
        "video_id": ids,
    }


class AugmentedRawMediaDataset:
    """Train-time augmentation wrapper (ref :1165-1215 semantics).

    Horizontal flip p=.5, brightness/contrast jitter, audio noise p=.3,
    title word-append p=.1 — numpy-only (no torchvision in this stack).
    """

    _EXTRA_WORDS = ("video", "content", "media", "clip", "footage")

    def __init__(self, base, augment: bool = True, seed: int = 0):
        self.base = base
        self.augment = augment
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        sample = self.base[i]
        if not self.augment:
            return sample
        rng = self._rng

        frames = sample["video_frames"]
        if rng.random() < 0.5:
            frames = frames[:, :, ::-1, :]  # horizontal flip
        scale = 1.0 + rng.uniform(-0.2, 0.2)  # brightness/contrast jitter
        shift = rng.uniform(-0.05, 0.05)
        if frames.dtype == np.uint8:
            # jitter in uint8 units (shift is in [0,1] units -> x255);
            # float32 scalars keep the temporary at 4 bytes/px (a Python
            # float would promote the whole array to float64)
            jittered = frames * np.float32(scale) + np.float32(shift * 255.0)
            sample["video_frames"] = np.clip(jittered, 0, 255).astype(
                np.uint8
            )
        else:
            sample["video_frames"] = np.clip(
                frames * scale + shift, 0.0, 1.0
            ).astype(np.float32)

        if rng.random() < 0.3:
            audio = sample["audio_waveform"]
            sample["audio_waveform"] = (
                audio + 0.01 * rng.standard_normal(audio.shape)
            ).astype(np.float32)

        if rng.random() < 0.1:
            td = dict(sample["text_data"])
            td["title"] = (
                td.get("title", "")
                + " "
                + str(rng.choice(self._EXTRA_WORDS))
            ).strip()
            sample["text_data"] = td
        return sample
