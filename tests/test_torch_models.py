"""PyTorch port: align MLP, graph context, GCN, fusion, forest and
classifier against their JAX modules.

Every comparison feeds the same numpy inputs to both sides, with
Flax-initialised params (`.init`) carried across by the port's bridge.
Tolerances: align MLP, GCN and classifier atol 1e-5; graph context
rtol 1e-6; fusion logits atol 1e-4 (PARITY.md §2.5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.models.classifier import (
    DeepTruthClassifier as JaxClassifier,
)
from ultrafnd_git_tpu.models.fusion import CrossModalTransformer as JaxFusion
from ultrafnd_git_tpu.models.gnn import SimpleGCN as JaxGCN
from ultrafnd_git_tpu.models.temporal import TemporalAlignMLP as JaxAlign
from ultrafnd_git_tpu.ops import graphctx as jax_graphctx
from ultrafnd_git_tpu.ops.trees import oblivious_forest_logits as jax_forest
from ultrafnd_git_tpu.utils.torch_transfer import (
    classifier_state_dict_from_params,
    gcn_state_dict_from_params,
)
from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier
from ultrafnd_git_tpu_torch.models.fusion import CrossModalTransformer
from ultrafnd_git_tpu_torch.models.gnn import SimpleGCN
from ultrafnd_git_tpu_torch.models.temporal import TemporalAlignMLP
from ultrafnd_git_tpu_torch.ops import graphctx
from ultrafnd_git_tpu_torch.ops.trees import oblivious_forest_logits
from ultrafnd_git_tpu_torch.utils.transfer import align_state_dict, fusion_state_dict

KEY = jax.random.PRNGKey(0)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _load(module, sd):
    module.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()})
    return module.eval()


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_align_mlp_matches_flax():
    rng = np.random.default_rng(0)
    t, v = _randn(rng, 6, 48), _randn(rng, 6, 40)  # v is zero-padded to 48
    t[0] = 0.0  # an empty record's all-zero text row
    jmod = JaxAlign(in_dim=48, out_dim=16)
    variables = jmod.init(KEY, jnp.asarray(t), jnp.asarray(v), deterministic=True)
    ref = jmod.apply(variables, jnp.asarray(t), jnp.asarray(v), deterministic=True)
    mod = _load(TemporalAlignMLP(48, 16), align_state_dict(jax.device_get(variables)))
    with torch.inference_mode():
        ours = mod(_t(t), _t(v))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def _corpus(n=40, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"tok{i}" for i in range(30)]
    ocr_sets = [set(rng.choice(vocab, size=int(rng.integers(0, 6)), replace=False))
                for _ in range(n)]
    return {
        "text": _randn(rng, n, 768),
        "audio": _randn(rng, n, 128),
        "visual": _randn(rng, n, 512),
        "temporal": _randn(rng, n, 256),
        "ocr_sets": ocr_sets,
    }


def test_graph_context_matches_jax():
    cache = _corpus()
    np.testing.assert_allclose(
        graphctx.compact_node_features(cache),
        jax_graphctx.compact_node_features(cache), rtol=1e-6,
    )
    ours = graphctx.build_graph_context(cache, 0.12)
    ref = jax_graphctx.build_graph_context(cache, 0.12)
    assert ref.adj.sum() > len(ref.adj)  # the corpus has edges
    for field in ("xg", "a_norm", "ax", "deg"):
        np.testing.assert_allclose(
            getattr(ours, field), getattr(ref, field), rtol=1e-6, atol=1e-7,
            err_msg=field,
        )


def test_gcn_matches_flax_dense_and_extension():
    cache = _corpus(seed=1)
    ctx = jax_graphctx.build_graph_context(cache, 0.12)
    jmod = JaxGCN(hid=32, out_dim=16)
    params = jmod.init(KEY, jnp.asarray(ctx.xg), jnp.asarray(ctx.a_norm),
                       normalize=False)["params"]
    mod = _load(SimpleGCN(416, 32, 16), gcn_state_dict_from_params(jax.device_get(params)))

    # full-graph dense forward
    ref = jmod.apply({"params": params}, jnp.asarray(ctx.xg),
                     jnp.asarray(ctx.a_norm), normalize=False)
    with torch.inference_mode():
        ours = mod(_t(ctx.a_norm), _t(ctx.xg))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)

    # serving-side new-node extension, the JAX serving program's math
    rng = np.random.default_rng(2)
    b = 5
    a_rows = (rng.uniform(size=(b, len(ctx.xg))) < 0.1).astype(np.float32) * 0.2
    self_w = rng.uniform(0.1, 1.0, size=b).astype(np.float32)
    xg_new = _randn(rng, b, 416)
    p = params
    h_corpus = jax.nn.gelu(
        jnp.asarray(ctx.ax) @ p["lin1"]["kernel"] + p["lin1"]["bias"],
        approximate=False,
    )
    ax_new = a_rows @ jnp.asarray(ctx.xg) + self_w[:, None] * xg_new
    h_new = jax.nn.gelu(ax_new @ p["lin1"]["kernel"] + p["lin1"]["bias"],
                        approximate=False)
    prop = a_rows @ h_corpus + self_w[:, None] * h_new
    ref_ext = prop @ p["lin2"]["kernel"] + p["lin2"]["bias"]
    with torch.inference_mode():
        hc = mod.corpus_hidden(_t(ctx.ax))
        ours_ext = mod.extend(_t(a_rows), _t(self_w), _t(xg_new), _t(ctx.xg), hc)
    np.testing.assert_allclose(hc.numpy(), np.asarray(h_corpus), atol=1e-5)
    np.testing.assert_allclose(ours_ext.numpy(), np.asarray(ref_ext), atol=1e-5)


def _feats(rng, b, use_gnn):
    f = {
        "text_features": _randn(rng, b, 768),
        "audio_features": _randn(rng, b, 128),
        "visual_features": _randn(rng, b, 512),
        "temporal_features": _randn(rng, b, 256),
    }
    if use_gnn:
        f["gnn_feat"] = _randn(rng, b, 128)
    return f


@pytest.mark.parametrize("use_gnn", [True, False])
def test_fusion_matches_flax(use_gnn):
    rng = np.random.default_rng(3)
    feats = _feats(rng, 6, use_gnn)
    jmod = JaxFusion(hidden=64, use_gnn=use_gnn)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    params = jmod.init(KEY, jfeats)["params"]
    ref = jmod.apply({"params": params}, jfeats, deterministic=True)
    mod = _load(
        CrossModalTransformer(hidden=64, use_gnn=use_gnn),
        fusion_state_dict(jax.device_get(params)),
    )
    with torch.inference_mode():
        ours = mod({k: _t(v) for k, v in feats.items()})
    np.testing.assert_allclose(ours["logits"].numpy(), np.asarray(ref["logits"]), atol=1e-4)
    np.testing.assert_allclose(ours["fused"].numpy(), np.asarray(ref["fused"]), atol=1e-4)
    for k, v in ref["forensic"].items():
        np.testing.assert_allclose(ours["forensic"][k].numpy(), np.asarray(v), atol=1e-5)


def test_forest_matches_jax():
    rng = np.random.default_rng(4)
    x, gates = _randn(rng, 7, 12), _randn(rng, 3, 4, 12)
    thresh, leaf = 0.1 * _randn(rng, 3, 4), _randn(rng, 3, 16, 2)
    ref = jax_forest(*(jnp.asarray(a) for a in (x, gates, thresh, leaf)), 10.0)
    ours = oblivious_forest_logits(*(_t(a) for a in (x, gates, thresh, leaf)), 10.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("temperature", [1.0, 0.2, 9.0])
def test_classifier_matches_flax(temperature):
    rng = np.random.default_rng(5)
    fused, aux = _randn(rng, 6, 64), rng.uniform(size=(6, 2)).astype(np.float32)
    jmod = JaxClassifier(hidden=32, node_trees=3, node_depth=3)
    params = jax.device_get(
        jmod.init(KEY, jnp.asarray(fused), jnp.asarray(aux))["params"]
    )
    # Flax starts the forest at zero; draw it so routing is exercised, and
    # move the temperature past both clip bounds
    params = dict(params)
    params["node"] = {
        "gates": _randn(rng, 3, 3, 32),
        "thresh": 0.1 * _randn(rng, 3, 3),
        "leaf_logits": _randn(rng, 3, 8, 2),
    }
    params["temperature"] = np.float32(temperature)
    ref = jmod.apply({"params": params}, jnp.asarray(fused), jnp.asarray(aux),
                     deterministic=True)
    mod = _load(
        DeepTruthClassifier(in_dim=64, hidden=32, node_trees=3, node_depth=3),
        classifier_state_dict_from_params(params, tau=10.0),
    )
    with torch.inference_mode():
        ours = mod(_t(fused), _t(aux))
    np.testing.assert_allclose(ours["probs"].numpy(), np.asarray(ref["probs"]), atol=1e-5)
    np.testing.assert_allclose(ours["logits"].numpy(), np.asarray(ref["logits"]), atol=1e-5)
