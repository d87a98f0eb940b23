"""PyTorch port, the RoBERTa emotion classifier twin (`models/roberta.py`)
against the JAX package's (`models/roberta_flax.py`) and the
`transformers` forward.

Hermetic, as `tests/test_roberta_flax.py`: a small randomly initialised
`transformers.RobertaForSequenceClassification` (no download), its weights
into the port as its `state_dict()` is, into the Flax twin through
`torch_roberta_clf_to_flax_params`, and back through
`utils/transfer.roberta_classifier_state_dict`. Covers the position-id
rule (cumulative non-pad count offset by the pad id), the dense + tanh
head, the label names and the refusal of a non-RoBERTa checkpoint.

Tolerance: logits and probabilities 1e-4 (the JAX test's).
"""
import os
import zlib

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")  # keep TensorFlow out of this process
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from ultrafnd_git_tpu.models.affective import AffectiveForensics as JaxAffective  # noqa: E402
from ultrafnd_git_tpu.models.roberta_flax import (  # noqa: E402
    DeviceEmotionClassifier as JaxEmotion,
    RobertaClassifierFlax,
    torch_roberta_clf_to_flax_params,
)
from ultrafnd_git_tpu_torch.models.affective import bucket_probs  # noqa: E402
from ultrafnd_git_tpu_torch.models.bert import load_hf_weights  # noqa: E402
from ultrafnd_git_tpu_torch.models.roberta import (  # noqa: E402
    DeviceEmotionClassifier,
    RobertaClassifier,
)
from ultrafnd_git_tpu_torch.utils.transfer import roberta_classifier_state_dict  # noqa: E402

VOCAB, PAD = 101, 1
TOL = dict(atol=1e-4, rtol=1e-4)
LABELS = {0: "anger", 1: "disgust", 2: "fear", 3: "joy", 4: "neutral", 5: "sadness",
          6: "surprise"}
TEXTS = ["scary alien warning", "joyful science discovery", "", "x", "word " * 30]


class IdsTokenizer:
    """A deterministic toy tokenizer with the HF call contract: <s>=0,
    words hashed into [4, VOCAB), </s>=2, right-padded with PAD."""

    def __call__(self, texts, padding=True, truncation=True, max_length=32,
                 return_tensors="np"):
        seqs = [[0] + [4 + zlib.crc32(w.encode()) % (VOCAB - 4) for w in (t or "").split()]
                [: max_length - 2] + [2] for t in texts]
        width = max(len(s) for s in seqs)
        ids = np.full((len(seqs), width), PAD, np.int64)
        mask = np.zeros((len(seqs), width), np.int64)
        for i, s in enumerate(seqs):
            ids[i, : len(s)], mask[i, : len(s)] = s, 1
        if return_tensors == "pt":
            return {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask)}
        return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def roberta():
    cfg = transformers.RobertaConfig(
        vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, max_position_embeddings=50, type_vocab_size=1,
        pad_token_id=PAD, num_labels=7, hidden_act="gelu", id2label=LABELS)
    torch.manual_seed(0)
    return transformers.RobertaForSequenceClassification(cfg).eval()


def _batch():
    ids = np.random.default_rng(0).integers(4, VOCAB, (3, 19))
    for i, n in enumerate([19, 11, 5]):
        ids[i, n:] = PAD
    return ids, (ids != PAD).astype(np.float32)


def _port(state_dict, cfg) -> RobertaClassifier:
    module = RobertaClassifier.from_config(cfg)
    load_hf_weights(module, state_dict, "roberta.")
    return module.eval()


def test_twin_logits_match_transformers_and_the_jax_twin(roberta):
    ids, mask = _batch()
    with torch.inference_mode():
        ref = roberta(input_ids=torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask).long()).logits.numpy()
        got = _port(roberta.state_dict(), roberta.config)(
            torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    flax = RobertaClassifierFlax(width=64, depth=2, heads=4, intermediate=128, vocab_size=VOCAB,
                                 max_positions=50, num_labels=7, pad_id=PAD,
                                 attention_backend="xla")
    params = torch_roberta_clf_to_flax_params(roberta.state_dict(), depth=2)
    jax_out = np.asarray(flax.apply({"params": params}, jnp.asarray(ids, jnp.int32),
                                    jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, jax_out, **TOL)


def test_jax_params_cross_the_bridge_exactly(roberta):
    sd = roberta_classifier_state_dict(torch_roberta_clf_to_flax_params(roberta.state_dict(), 2))
    assert set(sd) == set(RobertaClassifier.from_config(roberta.config).state_dict())
    hf = roberta.state_dict()
    for k, v in sd.items():
        key = k if k.startswith("classifier.") else f"roberta.{k}"
        np.testing.assert_array_equal(v, hf[key].numpy(), err_msg=k)


def test_device_classifier_matches_jax_and_transformers(roberta):
    tok = IdsTokenizer()
    clf = DeviceEmotionClassifier(roberta, tok, max_length=32, device="cpu")
    assert clf.label_names == [LABELS[i] for i in range(7)]
    got = clf.predict_probs(TEXTS)
    assert got.shape == (len(TEXTS), 7)
    jax_got = JaxEmotion(roberta, tok, max_length=32).predict_probs(TEXTS)
    with torch.inference_mode():
        ref = torch.softmax(roberta(**tok(TEXTS, return_tensors="pt")).logits, -1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, jax_got, **TOL)
    enc = tok(TEXTS)
    np.testing.assert_allclose(
        clf.predict_ids(enc["input_ids"], enc["attention_mask"].astype(np.float32)), got,
        atol=1e-6)
    from_sd = DeviceEmotionClassifier(roberta.state_dict(), tok, max_length=32, device="cpu",
                                      config=roberta.config.to_dict())
    np.testing.assert_array_equal(from_sd.predict_probs(TEXTS), got)


def test_label_buckets_equal_jax(roberta):
    p = np.random.default_rng(1).dirichlet(np.ones(7), size=5).astype(np.float32)
    names = [LABELS[i] for i in range(7)]
    np.testing.assert_array_equal(bucket_probs(p, names), JaxAffective._bucket_probs(p, names))


def test_non_roberta_checkpoint_refused():
    cfg = transformers.BertConfig(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=1,
                                  num_attention_heads=4, intermediate_size=128)
    with pytest.raises(ValueError, match="RoBERTa"):
        DeviceEmotionClassifier(transformers.BertModel(cfg), IdsTokenizer(), device="cpu")
