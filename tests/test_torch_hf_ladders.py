"""PyTorch port, the HF rungs of the four encoder ladders against the JAX
package's: the text ladder's BERT (`models/encoders.TextFieldEncoder`),
`SpectralForensics`'s wav2vec2, `SemanticForgeryAnalyzer`'s CLIP text
tower and `AffectiveForensics`'s emotion classifier.

Hermetic: small randomly initialised `transformers` models and tokenizers
are saved to a temporary directory, whose path is the model name, so both
packages' real loaders (`local_files_only=True`) load them. The ladders run
with `ULTRAFND_DISABLE_HF` unset and the memo of both packages reset.
Each routes its HF rung through the port's twin (on the CPU) and equals the
JAX ladder; `ULTRAFND_{BERT,W2V2,CLIP}_DEVICE=0`, an unsupported wav2vec2
checkpoint and a non-RoBERTa emotion model take the host forward without
building a twin; a twin that fails to build or to launch raises. The cache
fingerprint names the HF rungs and stays byte-identical on the hash rungs;
a fresh process that builds the ladders with `transformers` loaded holds no
jax module.

Tolerances: encodings and probabilities 1e-4 (wav2vec2 2e-4), the JAX
twin tests'.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")  # keep TensorFlow out of this process
transformers = pytest.importorskip("transformers")

from ultrafnd_git_tpu.data import cache as jax_cache  # noqa: E402
from ultrafnd_git_tpu.models.affective import AffectiveForensics as JaxAffective  # noqa: E402
from ultrafnd_git_tpu.models.audio import SpectralForensics as JaxSpectral  # noqa: E402
from ultrafnd_git_tpu.models.semantic import SemanticConfig as JaxSemanticConfig  # noqa: E402
from ultrafnd_git_tpu.models.semantic import SemanticForgeryAnalyzer as JaxSemantic  # noqa: E402
from ultrafnd_git_tpu.models.text import BERTContextEncoder  # noqa: E402
from ultrafnd_git_tpu.utils import hf as jax_hf  # noqa: E402
from ultrafnd_git_tpu_torch.data import cache as port_cache  # noqa: E402
from ultrafnd_git_tpu_torch.models import bert, clip, roberta, w2v2  # noqa: E402
from ultrafnd_git_tpu_torch.models.affective import AffectiveForensics  # noqa: E402
from ultrafnd_git_tpu_torch.models.audio import SpectralForensics  # noqa: E402
from ultrafnd_git_tpu_torch.models.encoders import TextFieldEncoder  # noqa: E402
from ultrafnd_git_tpu_torch.models.semantic import (  # noqa: E402
    SemanticConfig,
    SemanticForgeryAnalyzer,
)
from ultrafnd_git_tpu_torch.utils import hf  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "tests" / "fixtures" / "fakesv_tiny")
TOL = dict(atol=1e-4, rtol=1e-4)
W2V2_TOL = dict(atol=2e-4, rtol=2e-4)
TEXTS = ["hello world", "fake news video", "", "scary alien warning title"]
RECORDS = [{"title": "hello world", "ocr": "fake news", "comments": ["video", "", "title"]},
           {"title": "", "ocr": "", "comments": []},
           {"title": "scary alien", "ocr": None, "comments": ["warning"]}]
ENV = ("ULTRAFND_DISABLE_HF", "ULTRAFND_BERT_DEVICE", "ULTRAFND_W2V2_DEVICE",
       "ULTRAFND_CLIP_DEVICE", "ULTRAFND_TEXT_DEVICE", "ULTRAFND_TEXT_DEVICE_CKPT")
WORDS = ["[CLS]", "[PAD]", "[SEP]", "[UNK]", "hello", "world", "fake", "news", "video",
         "title", "scary", "alien", "warning"]


def _bert_tokenizer(root: Path):
    (root / "vocab.txt").write_text("\n".join(WORDS), encoding="utf-8")
    return transformers.BertTokenizer(str(root / "vocab.txt"), pad_token="[PAD]")


def _clip_tokenizer(root: Path):
    import string

    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in string.ascii_lowercase + string.digits:
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n")
    return transformers.CLIPTokenizer(str(root / "vocab.json"), str(root / "merges.txt"))


def _w2v2_processor(root: Path, do_normalize: bool = True):
    (root / "vocab.json").write_text(json.dumps({"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3,
                                                 "|": 4, "a": 5}))
    fe = transformers.Wav2Vec2FeatureExtractor(feature_size=1, sampling_rate=16000,
                                               padding_value=0.0, do_normalize=do_normalize,
                                               return_attention_mask=False)
    return transformers.Wav2Vec2Processor(
        feature_extractor=fe, tokenizer=transformers.Wav2Vec2CTCTokenizer(str(root / "vocab.json")))


def _save(root: Path, name: str, model, tokenizer) -> str:
    path = root / name
    torch.manual_seed(0)
    model.save_pretrained(path)
    tokenizer.save_pretrained(path)
    return str(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{rung: local model directory} of tiny randomly initialised models."""
    root = tmp_path_factory.mktemp("hf_models")
    torch.manual_seed(0)
    tok = _bert_tokenizer(root)
    bert_cfg = dict(vocab_size=len(WORDS), hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128, max_position_embeddings=48)
    labels = {0: "anger", 1: "fear", 2: "joy", 3: "neutral"}
    emo_cfg = transformers.RobertaConfig(**{**bert_cfg, "max_position_embeddings": 50},
                                         type_vocab_size=1, pad_token_id=1, num_labels=4,
                                         id2label=labels)
    text_cfg = dict(vocab_size=80, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=128, max_position_embeddings=32, bos_token_id=0,
                    eos_token_id=1, pad_token_id=1)
    vision_cfg = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                      num_attention_heads=2, image_size=32, patch_size=16)
    w2v2_cfg = dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=96, conv_dim=(24, 24, 24), conv_kernel=(10, 3, 3),
                    conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                    num_conv_pos_embedding_groups=4, apply_spec_augment=False)
    (root / "clip_vocab").mkdir()
    (root / "w2v2_vocab").mkdir()
    return {
        "bert": _save(root, "bert", transformers.BertModel(transformers.BertConfig(**bert_cfg)),
                      tok),
        "emotion": _save(root, "emotion",
                         transformers.RobertaForSequenceClassification(emo_cfg), tok),
        "emotion_bert": _save(root, "emotion_bert", transformers.BertForSequenceClassification(
            transformers.BertConfig(**bert_cfg, num_labels=4, id2label=labels)), tok),
        "clip": _save(root, "clip", transformers.CLIPModel(transformers.CLIPConfig(
            text_config=text_cfg, vision_config=vision_cfg, projection_dim=48)),
            _clip_tokenizer(root / "clip_vocab")),
        "w2v2": _save(root, "w2v2", transformers.Wav2Vec2Model(
            transformers.Wav2Vec2Config(**w2v2_cfg)), _w2v2_processor(root / "w2v2_vocab")),
        "w2v2_stable": _save(root, "w2v2_stable", transformers.Wav2Vec2Model(
            transformers.Wav2Vec2Config(**w2v2_cfg, do_stable_layer_norm=True,
                                        feat_extract_norm="layer")),
            _w2v2_processor(root / "w2v2_vocab")),
    }


@pytest.fixture(autouse=True)
def _hf_on(monkeypatch):
    """HF rungs on, every selector unset, both packages' memos empty."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    hf.reset_memo()
    jax_hf.reset_memo()
    yield
    hf.reset_memo()
    jax_hf.reset_memo()


def _waves(n=3, length=1600, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(length).astype(np.float32) for _ in range(n)]


def _never(*args, **kwargs):
    raise AssertionError("the device twin was built on a host-forward path")


# ---- each ladder routes its HF rung through the port's twin ---------------

def test_text_ladder_routes_bert_through_the_twin(models):
    ours = TextFieldEncoder(dim=64, max_length=32, device="cpu", model_name=models["bert"])
    got = ours.encode_batch(TEXTS)
    assert isinstance(ours._device_bert, bert.DeviceBertEncoder)  # the twin engaged
    assert not got[2].any()  # an empty string stays a zero row
    ref = BERTContextEncoder(model_name=models["bert"], dim=64, max_length=32).encode_batch(TEXTS)
    np.testing.assert_allclose(got, ref, **TOL)
    fields = BERTContextEncoder(model_name=models["bert"], dim=64, max_length=32)
    np.testing.assert_allclose(ours.encode_fields_batch(RECORDS),
                               fields.encode_fields_batch(RECORDS), **TOL)


def test_audio_ladder_routes_wav2vec2_through_the_twin(models):
    ours = SpectralForensics(dim=16, w2v2_name=models["w2v2"], device="cpu")
    waves = _waves()
    got = ours.extract_waveform_batch(waves)
    assert isinstance(ours._device_w2v2, w2v2.DeviceW2V2Encoder)
    ref = JaxSpectral(dim=16, w2v2_name=models["w2v2"]).extract_waveform_batch(waves)
    np.testing.assert_allclose(got, ref, **W2V2_TOL)
    # unequal lengths: the host forward a waveform at a time, as JAX's
    ragged = waves[:2] + _waves(1, 2000, seed=2)
    np.testing.assert_allclose(ours.extract_waveform_batch(ragged),
                               JaxSpectral(dim=16, w2v2_name=models["w2v2"])
                               .extract_waveform_batch(ragged), **W2V2_TOL)


def test_semantic_ladder_routes_clip_through_the_twin(models):
    ours = SemanticForgeryAnalyzer(SemanticConfig(model_name=models["clip"], max_length=24),
                                   device="cpu")
    got = ours.encode_text(TEXTS)
    assert isinstance(ours._twin, clip.DeviceClipTextEncoder)
    ref = JaxSemantic(JaxSemanticConfig(model_name=models["clip"], max_length=24))
    np.testing.assert_allclose(got, ref.encode_text(TEXTS), **TOL)
    np.testing.assert_allclose(ours.gap_magnitude(TEXTS, TEXTS[::-1]),
                               ref.gap_magnitude(TEXTS, TEXTS[::-1]), **TOL)


def test_affective_ladder_routes_the_emotion_model_through_the_twin(models):
    ours = AffectiveForensics(text_model=models["emotion"], device="cpu")
    got = ours.analyze_batch(TEXTS)
    assert isinstance(ours._twin, roberta.DeviceEmotionClassifier)
    ref = JaxAffective(text_model=models["emotion"]).analyze_batch(TEXTS)
    for key in ("probs", "intensity", "valence"):
        np.testing.assert_allclose(got[key], ref[key], **TOL)


# ---- the host forwards ------------------------------------------------------

def test_device_switches_off_take_the_host_forwards(models, monkeypatch):
    """ULTRAFND_{BERT,W2V2,CLIP}_DEVICE=0 take the `transformers` forward,
    build no twin, and agree with the twins and with JAX's host paths."""
    twin_text = TextFieldEncoder(dim=64, max_length=32, device="cpu",
                                 model_name=models["bert"]).encode_batch(TEXTS)
    twin_audio = SpectralForensics(dim=16, w2v2_name=models["w2v2"],
                                   device="cpu").extract_waveform_batch(_waves())
    clip_cfg = SemanticConfig(model_name=models["clip"], max_length=24)
    twin_clip = SemanticForgeryAnalyzer(clip_cfg, device="cpu").encode_text(TEXTS)
    for name in ("BERT", "W2V2", "CLIP"):
        monkeypatch.setenv(f"ULTRAFND_{name}_DEVICE", "0")
    for cls in (bert.DeviceBertEncoder, w2v2.DeviceW2V2Encoder, clip.DeviceClipTextEncoder):
        monkeypatch.setattr(cls, "__init__", _never)
    host_text = TextFieldEncoder(dim=64, max_length=32, device="cpu",
                                 model_name=models["bert"]).encode_batch(TEXTS)
    host_audio = SpectralForensics(dim=16, w2v2_name=models["w2v2"],
                                   device="cpu").extract_waveform_batch(_waves())
    host_clip = SemanticForgeryAnalyzer(clip_cfg, device="cpu").encode_text(TEXTS)
    np.testing.assert_allclose(host_text, twin_text, **TOL)
    np.testing.assert_allclose(host_audio, twin_audio, **W2V2_TOL)
    np.testing.assert_allclose(host_clip, twin_clip, **TOL)
    np.testing.assert_allclose(host_text, BERTContextEncoder(
        model_name=models["bert"], dim=64, max_length=32).encode_batch(TEXTS), **TOL)
    np.testing.assert_allclose(host_audio, JaxSpectral(
        dim=16, w2v2_name=models["w2v2"]).extract_waveform_batch(_waves()), **W2V2_TOL)
    np.testing.assert_allclose(host_clip, JaxSemantic(JaxSemanticConfig(
        model_name=models["clip"], max_length=24)).encode_text(TEXTS), **TOL)


def test_unsupported_checkpoints_take_the_host_forward(models, monkeypatch):
    """A stable-LN wav2vec2 and a BERT emotion model are selected for the
    host forward before any twin is built (no exception is caught)."""
    monkeypatch.setattr(w2v2.DeviceW2V2Encoder, "__init__", _never)
    monkeypatch.setattr(roberta.DeviceEmotionClassifier, "__init__", _never)
    waves = _waves()
    got = SpectralForensics(dim=16, w2v2_name=models["w2v2_stable"],
                            device="cpu").extract_waveform_batch(waves)
    ref = JaxSpectral(dim=16, w2v2_name=models["w2v2_stable"]).extract_waveform_batch(waves)
    np.testing.assert_allclose(got, ref, **W2V2_TOL)
    probs = AffectiveForensics(text_model=models["emotion_bert"],
                               device="cpu").text_probs_batch(TEXTS)
    np.testing.assert_allclose(probs, JaxAffective(
        text_model=models["emotion_bert"]).text_probs_batch(TEXTS), **TOL)


def test_lower_rungs_only_without_the_model(models):
    """No local model: the hash, spectral and lexicon rungs, as before."""
    from ultrafnd_git_tpu_torch.models.affective import lexicon_probs_batch
    from ultrafnd_git_tpu_torch.ops.hashing import hash_embed_batch

    missing = str(Path(models["bert"]).parent / "absent")
    text = TextFieldEncoder(dim=64, device="cpu", model_name=missing)
    assert not text.use_hf
    np.testing.assert_array_equal(text.encode_batch(TEXTS), hash_embed_batch(TEXTS, 64))
    assert not SpectralForensics(dim=16, w2v2_name=missing, device="cpu").use_w2v2
    sem = SemanticForgeryAnalyzer(SemanticConfig(model_name=missing), device="cpu")
    np.testing.assert_array_equal(sem.encode_text(TEXTS), hash_embed_batch(TEXTS, 512,
                                                                          max_tokens=512))
    np.testing.assert_array_equal(
        AffectiveForensics(text_model=missing, device="cpu").text_probs_batch(TEXTS),
        lexicon_probs_batch(TEXTS))


# ---- a failing twin raises ---------------------------------------------------

def _boom(*args, **kwargs):
    raise RuntimeError("twin failed")


LADDERS = {
    "bert": (bert.DeviceBertEncoder, "encode_batch",
             lambda m: TextFieldEncoder(dim=64, max_length=32, device="cpu",
                                        model_name=m["bert"]).encode_batch(TEXTS)),
    "w2v2": (w2v2.DeviceW2V2Encoder, "encode_batch",
             lambda m: SpectralForensics(dim=16, w2v2_name=m["w2v2"], device="cpu")
             .extract_waveform_batch(_waves())),
    "clip": (clip.DeviceClipTextEncoder, "encode_batch",
             lambda m: SemanticForgeryAnalyzer(SemanticConfig(model_name=m["clip"]),
                                               device="cpu").encode_text(TEXTS)),
    "emotion": (roberta.DeviceEmotionClassifier, "predict_probs",
                lambda m: AffectiveForensics(text_model=m["emotion"], device="cpu")
                .text_probs_batch(TEXTS)),
}


@pytest.mark.parametrize("stage", ["build", "launch"])
@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_a_failing_twin_raises(models, monkeypatch, ladder, stage):
    cls, method, run = LADDERS[ladder]
    monkeypatch.setattr(cls, "__init__" if stage == "build" else method, _boom)
    with pytest.raises(RuntimeError, match="twin failed"):
        run(models)


# ---- the cache fingerprint ---------------------------------------------------

def _loaded(path, kind):
    tok = transformers.AutoTokenizer.from_pretrained(path, local_files_only=True)
    model = {"text": transformers.AutoModel, "clip": transformers.CLIPModel,
             "affective": transformers.AutoModelForSequenceClassification}[kind]
    return tok, model.from_pretrained(path, local_files_only=True).eval()


def test_fingerprint_names_the_hf_rungs(models, monkeypatch):
    """The hash rungs' fingerprint is JAX's + the align draw (HF off, and
    HF on without local weights); each HF rung that loads is named with its
    device/host mark; the tower of a checkpoint still outranks BERT; a cache
    built on one rung is not taken under another."""
    plain = json.loads(port_cache.cache_fingerprint(TINY, 0, None))
    assert plain == {**json.loads(jax_cache.cache_fingerprint(TINY, 0, None)),
                     "align_init": "torch"}
    monkeypatch.setenv("ULTRAFND_DISABLE_HF", "1")
    hashed = port_cache.cache_fingerprint(TINY, 0, None)
    assert json.loads(hashed) == plain
    monkeypatch.delenv("ULTRAFND_DISABLE_HF")
    # the default model names, memoised with the tiny models
    hf.reset_memo()
    hf.load_once("text:bert-base-uncased", lambda: _loaded(models["bert"], "text"))
    text = json.loads(port_cache.cache_fingerprint(TINY, 0, None))
    assert text == {**plain, "text_rung": "hf:bert-base-uncased:device"}
    monkeypatch.setenv("ULTRAFND_BERT_DEVICE", "0")
    assert json.loads(port_cache.cache_fingerprint(TINY, 0, None))["text_rung"] == \
        "hf:bert-base-uncased:host"
    monkeypatch.setenv("ULTRAFND_TEXT_DEVICE", "1")  # the seeded tower ranks below HF
    assert json.loads(port_cache.cache_fingerprint(TINY, 0, None))["text_rung"] == \
        "hf:bert-base-uncased:host"
    monkeypatch.delenv("ULTRAFND_TEXT_DEVICE")
    hf.reset_memo()
    for key, path, kind in (("clip:openai/clip-vit-base-patch32", models["clip"], "clip"),
                            ("affective:j-hartmann/emotion-english-distilroberta-base",
                             models["emotion"], "affective")):
        hf.load_once(key, lambda: _loaded(path, kind))
    monkeypatch.setenv("ULTRAFND_CLIP_DEVICE", "0")
    full = json.loads(port_cache.cache_fingerprint(TINY, 0, None))
    assert full == {**plain, "evidence_rungs": {
        "semantic": "hf:openai/clip-vit-base-patch32:host",
        "affective": "hf:j-hartmann/emotion-english-distilroberta-base:device"}}
    fp = port_cache.cache_fingerprint(TINY, 0, None)
    cache = port_cache.build_feature_cache(
        _Raw(), encoders=port_cache.make_encoders(text_dim=64, device="cpu"), text_dim=64)
    path = Path(models["bert"]).parent / "feature_cache.npz"
    port_cache.save_cache(cache, str(path), fingerprint=hashed)
    assert port_cache.load_cache(str(path), expected_fingerprint=fp) is None
    port_cache.save_cache(cache, str(path), fingerprint=fp)
    assert port_cache.load_cache(str(path), expected_fingerprint=fp) is not None


class _Raw:
    """Three records with the dataset contract `build_feature_cache` reads."""

    def __len__(self):
        return len(RECORDS)

    def get_item(self, i):
        return {"id": str(i), "label": i % 2, "title": RECORDS[i]["title"] or "",
                "ocr": RECORDS[i]["ocr"] or "", "comments": RECORDS[i]["comments"]}


# ---- no jax in the port's process ---------------------------------------------

WORKER = """
import sys
import numpy as np
from ultrafnd_git_tpu_torch.models.affective import AffectiveForensics
from ultrafnd_git_tpu_torch.models.audio import SpectralForensics
from ultrafnd_git_tpu_torch.models.encoders import TextFieldEncoder
from ultrafnd_git_tpu_torch.models.semantic import SemanticConfig, SemanticForgeryAnalyzer
m = {models}
texts = ["hello world", "scary alien"]
text = TextFieldEncoder(dim=64, max_length=32, device="cpu", model_name=m["bert"])
audio = SpectralForensics(dim=16, w2v2_name=m["w2v2"], device="cpu")
sem = SemanticForgeryAnalyzer(SemanticConfig(model_name=m["clip"], max_length=24), device="cpu")
aff = AffectiveForensics(text_model=m["emotion"], device="cpu")
rows = [text.encode_batch(texts), audio.extract_waveform_batch([np.ones(1600, np.float32)] * 2),
        sem.encode_text(texts), aff.text_probs_batch(texts)]
assert all(np.isfinite(r).all() for r in rows)
assert text._device_bert and audio._device_w2v2 and sem._twin and aff._twin
assert "transformers" in sys.modules
print(sorted(k for k in sys.modules if k.split(".")[0] in
             ("jax", "jaxlib", "flax", "tensorflow", "ultrafnd_git_tpu")))
"""


def test_fresh_process_builds_the_ladders_without_jax(models):
    env = {k: v for k, v in os.environ.items()
           if k not in ENV + ("USE_TF", "USE_FLAX", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", WORKER.format(models=repr(models))], env=env,
                         capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
