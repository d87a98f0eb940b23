"""PyTorch port, the wav2vec2 twin (`models/w2v2.py`) against the JAX
package's (`models/w2v2_flax.py`) and the `transformers` forward.

Hermetic, as `tests/test_w2v2_flax.py`: a small randomly initialised
`transformers.Wav2Vec2Model` in the BASE layout (no download), its weights
into the port as its `state_dict()` is (the positional conv's weight
materialised from either weight-norm layout), into the Flax twin through
`torch_w2v2_to_flax_params`, and back through
`utils/transfer.w2v2_state_dict`. Covers the pooled, seeded-projection
encode contract and the configurations the tower refuses.

Tolerance: hidden states and encodings 2e-4 (the JAX test's).
"""
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")  # keep TensorFlow out of this process
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from ultrafnd_git_tpu.models.w2v2_flax import DeviceW2V2Encoder as JaxW2V2  # noqa: E402
from ultrafnd_git_tpu.models.w2v2_flax import (  # noqa: E402
    Wav2Vec2EncoderFlax,
    torch_w2v2_to_flax_params,
)
from ultrafnd_git_tpu_torch.models.w2v2 import (  # noqa: E402
    POS_CONV,
    DeviceW2V2Encoder,
    Wav2Vec2Encoder,
    load_w2v2_weights,
    unsupported,
)
from ultrafnd_git_tpu_torch.utils.transfer import w2v2_state_dict  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
SMALL = dict(vocab_size=32, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=96, conv_dim=(24, 24, 24), conv_kernel=(10, 3, 3),
             conv_stride=(5, 2, 2), conv_bias=False, num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4, do_stable_layer_norm=False,
             feat_extract_norm="group", hidden_act="gelu", apply_spec_augment=False)


@pytest.fixture(scope="module")
def w2v2():
    torch.manual_seed(0)
    return transformers.Wav2Vec2Model(transformers.Wav2Vec2Config(**SMALL)).eval()


def _port(state_dict, cfg) -> Wav2Vec2Encoder:
    module = Wav2Vec2Encoder.from_config(cfg)
    load_w2v2_weights(module, state_dict)
    return module.eval()


def _run(module, wave) -> np.ndarray:
    with torch.inference_mode():
        return module(torch.from_numpy(wave)).numpy()


def _legacy(sd):
    """The state dict with the positional conv in the weight_g / weight_v
    layout of older torch."""
    out = {k: v for k, v in sd.items() if ".parametrizations." not in k}
    out[f"{POS_CONV}.weight_g"] = sd[f"{POS_CONV}.parametrizations.weight.original0"]
    out[f"{POS_CONV}.weight_v"] = sd[f"{POS_CONV}.parametrizations.weight.original1"]
    return out


def test_twin_matches_transformers_and_the_jax_twin(w2v2):
    wave = np.random.default_rng(0).standard_normal((2, 2000)).astype(np.float32)
    with torch.inference_mode():
        ref = w2v2(torch.from_numpy(wave)).last_hidden_state.numpy()
    got = _run(_port(w2v2.state_dict(), w2v2.config), wave)
    cfg = w2v2.config
    flax = Wav2Vec2EncoderFlax(width=48, depth=2, heads=4, intermediate=96,
                               conv_dim=cfg.conv_dim, conv_kernel=cfg.conv_kernel,
                               conv_stride=cfg.conv_stride, conv_bias=False,
                               pos_conv_kernel=16, pos_conv_groups=4)
    params = torch_w2v2_to_flax_params(w2v2.state_dict(), 2, 3)
    jax_out = np.asarray(flax.apply({"params": params}, jnp.asarray(wave)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, jax_out, **TOL)


def test_both_weight_norm_layouts_and_the_prefix_load_alike(w2v2):
    """weight_g / weight_v (older torch) and parametrizations.* give the
    same module, so do `wav2vec2.`-prefixed keys; the materialised weight
    is the JAX transfer's kernel."""
    sd = w2v2.state_dict()
    if f"{POS_CONV}.parametrizations.weight.original0" not in sd:
        pytest.skip("this torch stores the positional conv's weight materialised")
    wave = np.random.default_rng(1).standard_normal((1, 1600)).astype(np.float32)
    ref = _run(_port(sd, w2v2.config), wave)
    np.testing.assert_array_equal(_run(_port(_legacy(sd), w2v2.config), wave), ref)
    prefixed = {f"wav2vec2.{k}": v for k, v in sd.items()}
    np.testing.assert_array_equal(_run(_port(prefixed, w2v2.config), wave), ref)
    weight = _port(_legacy(sd), w2v2.config).encoder.pos_conv_embed.conv.weight.detach().numpy()
    flax_kernel = torch_w2v2_to_flax_params(sd, 2, 3)["pos_conv"]["kernel"]
    np.testing.assert_allclose(weight, np.transpose(flax_kernel, (2, 1, 0)), atol=1e-7)


def test_jax_params_cross_the_bridge(w2v2):
    sd = w2v2_state_dict(torch_w2v2_to_flax_params(w2v2.state_dict(), 2, 3))
    assert set(sd) == set(Wav2Vec2Encoder.from_config(w2v2.config).state_dict())
    wave = np.random.default_rng(2).standard_normal((2, 1600)).astype(np.float32)
    np.testing.assert_array_equal(_run(_port(sd, w2v2.config), wave),
                                  _run(_port(w2v2.state_dict(), w2v2.config), wave))


def test_device_encoder_matches_jax_and_the_torch_contract(w2v2):
    """normalise -> forward -> mean over time -> the seeded projection, in
    power-of-two batch chunks, as the JAX twin and the host recipe."""
    rng = np.random.default_rng(1)
    waves = [rng.standard_normal(1600).astype(np.float32) for _ in range(3)]
    enc = DeviceW2V2Encoder(w2v2, dim=16, batch_size=2, device="cpu")
    got = enc.encode_batch(waves)
    assert got.shape == (3, 16)
    jax_got = JaxW2V2(w2v2, dim=16, batch_size=2, proj_seed=0).encode_batch(waves)
    g = torch.Generator().manual_seed(0)
    w = torch.randn(16, 48, generator=g) / 48 ** 0.5
    arr = np.stack(waves)
    normed = (arr - arr.mean(-1, keepdims=True)) / np.sqrt(arr.var(-1, keepdims=True) + 1e-7)
    with torch.inference_mode():
        ref = (w2v2(torch.from_numpy(normed)).last_hidden_state.mean(dim=1) @ w.T).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, jax_got, **TOL)
    same_width = DeviceW2V2Encoder(w2v2.state_dict(), dim=48, device="cpu",
                                   config=w2v2.config.to_dict()).encode_batch(waves)
    np.testing.assert_allclose(same_width, JaxW2V2(w2v2, dim=48).encode_batch(waves), **TOL)


class _Processor:
    def __init__(self, do_normalize):
        self.feature_extractor = type("FE", (), {"do_normalize": do_normalize})()


@pytest.mark.parametrize("change,processor,reason", [
    ({"do_stable_layer_norm": True, "feat_extract_norm": "layer"}, None, "do_stable_layer_norm"),
    ({"hidden_act": "gelu_new"}, None, "hidden_act='gelu_new'"),
    ({"feat_extract_activation": "relu"}, None, "feat_extract_activation='relu'"),
    ({}, _Processor(False), "do_normalize=False"),
], ids=["stable_layer_norm", "hidden_act", "feat_extract_activation", "do_normalize"])
def test_unsupported_configs_are_named_and_refused(change, processor, reason):
    cfg = transformers.Wav2Vec2Config(**{**SMALL, "num_hidden_layers": 1, **change})
    assert reason in unsupported(cfg, processor)
    with pytest.raises(ValueError, match=reason.split("=")[0]):
        DeviceW2V2Encoder(transformers.Wav2Vec2Model(cfg), dim=16, processor=processor,
                          device="cpu")
    assert unsupported(transformers.Wav2Vec2Config(**SMALL), _Processor(True)) is None
