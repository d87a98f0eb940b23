"""PyTorch port: hash tokenizer and text tower against the JAX package.

The tower runs on Flax-initialised weights carried across by the port's
bridge (`utils/transfer.tower_state_dict`), on the same numpy inputs;
pooled outputs agree to atol 1e-5 in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.models.transformer import (
    TextTransformer as JaxTextTransformer,
    hash_tokenize_batch as jax_hash_tokenize_batch,
)
from ultrafnd_git_tpu.ops.hashing import get_hash_salt, set_hash_salt
from ultrafnd_git_tpu_torch.ops import hashing as port_hashing
from ultrafnd_git_tpu_torch.models.transformer import (
    TextTransformer,
    hash_tokenize_batch,
)
from ultrafnd_git_tpu_torch.utils.transfer import tower_state_dict

TEXTS = [
    "外星人 入侵 地球 警告 第0期",
    "辟谣 谣言 不实 hello world 2024 abc中文def",
    "",
    "   ",
    "a " * 80,
    "专家 辟谣 谣言 证据 科学 视频 记录 这是真的吗 太可怕了 赶紧转发",
]


@pytest.mark.parametrize("salt", ["", "other-salt"])
def test_hash_tokenize_ids_identical(salt):
    prev = get_hash_salt(), port_hashing.get_hash_salt()
    try:
        set_hash_salt(salt)  # each package keeps its own process-wide salt
        port_hashing.set_hash_salt(salt)
        ours = hash_tokenize_batch(TEXTS, 64, 32768)
        ref = jax_hash_tokenize_batch(TEXTS, 64, 32768)
        pinned = hash_tokenize_batch(TEXTS, 64, 32768, salt="pinned")
        ref_pinned = jax_hash_tokenize_batch(TEXTS, 64, 32768, salt="pinned")
    finally:
        set_hash_salt(prev[0])
        port_hashing.set_hash_salt(prev[1])
    for a, b in ((ours, ref), (pinned, ref_pinned)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[0].dtype == np.int32 and a[1].dtype == np.float32


@pytest.mark.parametrize("gelu", ["tanh", "exact"])
def test_text_tower_matches_flax(gelu):
    width, heads, vocab, seq = 256, 4, 512, 16
    jmod = JaxTextTransformer(
        width=width, depth=1, heads=heads, vocab_size=vocab, max_len=seq,
        gelu=gelu,
    )
    rng = np.random.default_rng(0)
    ids = rng.integers(1, vocab, size=(3, seq)).astype(np.int32)
    lengths = np.array([seq, 5, 0])  # full, padded, and all-padding rows
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.float32)
    ids = ids * mask.astype(np.int32)
    params = jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
        deterministic=True,
    )["params"]
    ref = jmod.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask),
        deterministic=True,
    )

    tower = TextTransformer(width=width, depth=1, heads=heads, vocab_size=vocab,
                            max_len=seq, gelu=gelu)
    sd = tower_state_dict(jax.device_get(params))
    tower.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.inference_mode():
        ours = tower.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
