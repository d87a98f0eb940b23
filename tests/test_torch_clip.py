"""PyTorch port, the CLIP text-tower twin (`models/clip.py`) against the JAX
package's (`models/clip_flax.py`) and the `transformers` forward.

Hermetic, as `tests/test_clip_flax.py`: a small randomly initialised
`transformers.CLIPTextModelWithProjection` (no download), its weights into
the port as its `state_dict()` is, into the Flax twin through
`torch_clip_text_to_flax_params`, and back through
`utils/transfer.clip_text_state_dict`. Covers EOS pooling (first EOS, and
argmax(ids) for a config whose eos_token_id is 2), a whole `CLIPModel`'s
state dict, and the L2-normalised encode contract with a real
`CLIPTokenizer` (character vocabulary, no merges).

Tolerance: features 1e-4 (the JAX test's).
"""
import json
import os
import string

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")  # keep TensorFlow out of this process
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from ultrafnd_git_tpu.models.clip_flax import DeviceClipTextEncoder as JaxClip  # noqa: E402
from ultrafnd_git_tpu.models.clip_flax import (  # noqa: E402
    ClipTextEncoderFlax,
    torch_clip_text_to_flax_params,
)
from ultrafnd_git_tpu_torch.models.bert import load_hf_weights  # noqa: E402
from ultrafnd_git_tpu_torch.models.clip import ClipTextEncoder, DeviceClipTextEncoder  # noqa: E402
from ultrafnd_git_tpu_torch.utils.transfer import clip_text_state_dict  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
TEXTS = ["hello world", "fake news 42", "", "a much longer title than the others"]


def _text_config(eos: int = 1):
    return transformers.CLIPTextConfig(
        vocab_size=96, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, max_position_embeddings=32, projection_dim=48,
        hidden_act="quick_gelu", bos_token_id=0, eos_token_id=eos, pad_token_id=eos)


def _clip(eos: int = 1):
    torch.manual_seed(0)
    return transformers.CLIPTextModelWithProjection(_text_config(eos)).eval()


@pytest.fixture(scope="module")
def clip():
    return _clip()


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip_vocab")
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in string.ascii_lowercase + string.digits:
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n")
    return transformers.CLIPTokenizer(str(root / "vocab.json"), str(root / "merges.txt"))


def _ids(eos: int, length: int):
    """Random ids with an EOS and EOS padding after it."""
    rng = np.random.default_rng(eos)
    ids = rng.integers(2, 96, (3, length))
    mask = np.ones((3, length), np.float32)
    for i, at in enumerate([length - 1, 5, 9]):
        ids[i, at:] = eos
        mask[i, at + 1:] = 0.0
    return ids, mask


def _port(state_dict, cfg) -> ClipTextEncoder:
    module = ClipTextEncoder.from_config(cfg)
    load_hf_weights(module, state_dict, "text_model.")
    return module.eval()


@pytest.mark.parametrize("eos", [1, 2], ids=["first_eos", "legacy_argmax"])
def test_twin_matches_transformers_and_the_jax_twin(eos):
    model = _clip(eos)
    ids, mask = _ids(eos, 19)
    with torch.inference_mode():
        ref = model(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask).long()).text_embeds.numpy()
        got, hidden = _port(model.state_dict(), model.config)(torch.from_numpy(ids),
                                                              torch.from_numpy(mask))
    assert hidden.shape == (3, 19, 64)
    cfg = model.config
    flax = ClipTextEncoderFlax(width=64, depth=2, heads=4, intermediate=128, vocab_size=96,
                               max_positions=32, proj_dim=48, hidden_act="quick_gelu",
                               ln_eps=cfg.layer_norm_eps, eos_token_id=eos,
                               legacy_eos_pooling=eos == 2)
    params = torch_clip_text_to_flax_params(model.state_dict(), 2)
    jax_out, _ = flax.apply({"params": params}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), **TOL)


def test_jax_params_cross_the_bridge_exactly(clip):
    sd = clip_text_state_dict(torch_clip_text_to_flax_params(clip.state_dict(), 2))
    assert set(sd) == set(ClipTextEncoder.from_config(clip.config).state_dict())
    hf = clip.state_dict()
    for k, v in sd.items():
        key = k if k == "text_projection.weight" else f"text_model.{k}"
        np.testing.assert_array_equal(v, hf[key].numpy(), err_msg=k)


def test_device_encoder_matches_jax_and_the_torch_contract(clip, tok):
    enc = DeviceClipTextEncoder(clip, tok, max_length=24, device="cpu")
    got = enc.encode_batch(TEXTS)
    assert got.shape == (len(TEXTS), 48)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-4)
    batch = tok(TEXTS, return_tensors="pt", padding="max_length", truncation=True,
                max_length=24)
    with torch.inference_mode():
        ref = clip(**batch).text_embeds.numpy()
    ref = ref / (np.linalg.norm(ref, axis=-1, keepdims=True) + 1e-9)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, JaxClip(clip, tok, max_length=24).encode_batch(TEXTS), **TOL)
    ids = batch["input_ids"].numpy()
    np.testing.assert_allclose(enc.encode_ids(ids, batch["attention_mask"].numpy()), got,
                               atol=1e-6)


def test_a_whole_clip_model_state_dict_loads(clip, tok):
    """A `CLIPModel` (both towers, `text_config` and `projection_dim` on its
    config) loads as its text tower does; the vision keys are ignored."""
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                  num_attention_heads=2, image_size=32, patch_size=16)
    cfg = transformers.CLIPConfig(text_config=_text_config().to_dict(), vision_config=vision,
                                  projection_dim=48)
    torch.manual_seed(0)
    model = transformers.CLIPModel(cfg).eval()
    got = DeviceClipTextEncoder(model, tok, max_length=24, device="cpu").encode_batch(TEXTS)
    batch = tok(TEXTS, return_tensors="pt", padding="max_length", truncation=True,
                max_length=24)
    with torch.inference_mode():
        ref = model.get_text_features(**batch).numpy()
    np.testing.assert_allclose(got, ref / (np.linalg.norm(ref, axis=-1, keepdims=True) + 1e-9),
                               **TOL)
