"""PyTorch port, the sparse graph layout (`--sparse_graph`) against the JAX
package on the CPU.

* The edge list (`ops/jaccard.build_edges_from_ocr`, native and numpy)
  equals the JAX one exactly; the port's binding raises where the C++ fill
  writes another count than its first pass (the JAX binding's bare
  `assert` would be stripped by `python -O`).
* The neighbour lists: nbr_idx equal to JAX's, nbr_w at rtol 1e-6, ax at
  rtol 1e-5 (the JAX suite's bounds, tests/test_sparse_graph.py:113-114).
* The sparse GCN against the dense one: rtol 1e-5 forward, 2e-4 in its
  gradients (tests/test_sparse_graph.py:150-159).
* Training: the port trainer's loss and gradient under sparse_graph match
  `jax.grad` of the JAX trainer's at atol 1e-5, rtol 1e-4 (as
  test_torch_training.py), and so does the GCN pretrain's.
* A sparse checkpoint of the port's trainer records sparse_graph in its
  exported meta.json and serves through both layouts within 1e-5.
"""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.ops.graphctx import build_sparse_graph_context as jax_sparse_ctx
from ultrafnd_git_tpu.ops.jaccard import build_edges_from_ocr as jax_edges
from ultrafnd_git_tpu_torch import native
from ultrafnd_git_tpu_torch.models.gnn import SimpleGCN
from ultrafnd_git_tpu_torch.ops.graphctx import build_graph_context, build_sparse_graph_context
from ultrafnd_git_tpu_torch.ops.jaccard import build_edges_from_ocr
from ultrafnd_git_tpu_torch.training import trainer as port
from ultrafnd_git_tpu_torch.utils.transfer import port_state_dicts

TOL = dict(atol=1e-5, rtol=1e-4)


def _random_sets(n, seed=0, vocab=40):
    rng = np.random.default_rng(seed)
    return [{f"t{x}" for x in rng.integers(0, vocab, size=rng.integers(0, 9))}
            for _ in range(n)]


def _cache(n=96, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "labels": rng.integers(0, 2, n).astype(np.int64),
        **{k: rng.standard_normal((n, w)).astype(np.float32)
           for k, w in (("text", 768), ("audio", 128), ("visual", 512), ("temporal", 256))},
        "ocr_sets": _random_sets(n, seed + 1),
    }


@pytest.mark.parametrize("weighted", [False, True], ids=["binary", "weighted"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_edge_list_equals_jax(use_native, weighted, monkeypatch):
    if not use_native:
        monkeypatch.setenv("ULTRAFND_NATIVE", "0")
    sets = _random_sets(140)
    ours = build_edges_from_ocr(sets, 0.12, weighted=weighted, block_rows=None if use_native else 17)
    ref = jax_edges(sets, 0.12, weighted=weighted)
    assert (native.get_lib("graphops") is not None) == use_native
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(ours[0]) > 0 and (ours[0] != ours[1]).all()  # no diagonal


def test_edge_binding_raises_on_a_short_fill(monkeypatch):
    calls = []

    class ShortFill:  # counts 4 entries, then fills 2
        def ufnd_jaccard_edges(self, *args):
            calls.append(args[6])
            return 4 if args[6] == 0 else 2

    monkeypatch.setattr(native, "get_lib", lambda name: ShortFill())
    with pytest.raises(RuntimeError, match="counted 4 entries but the fill pass gave 2"):
        native.jaccard_edges_native([{"a", "b"}, {"a", "b"}], 0.12)
    assert calls == [0, 4]


def test_sparse_context_matches_jax():
    cache = _cache()
    ours, ref = build_sparse_graph_context(cache, 0.12), jax_sparse_ctx(cache, 0.12)
    assert ours.k_max == ref.k_max > 1
    np.testing.assert_array_equal(ours.nbr_idx, ref.nbr_idx)
    np.testing.assert_allclose(ours.nbr_w, ref.nbr_w, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ours.ax, ref.ax, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ours.deg, ref.deg)
    np.testing.assert_array_equal(ours.xg, ref.xg)
    # the lists hold exactly the dense a_norm's nonzeros
    dense = build_graph_context(cache, 0.12)
    recon = np.zeros_like(dense.a_norm)
    np.add.at(recon, (np.arange(len(cache["labels"]))[:, None], ours.nbr_idx), ours.nbr_w)
    np.testing.assert_allclose(recon, dense.a_norm, rtol=1e-6, atol=1e-9)


def test_hub_degree_warns():
    cache = _cache(n=80)
    cache["ocr_sets"] = [{"hub", f"x{i}"} for i in range(80)]  # every pair links
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        ctx = build_sparse_graph_context(cache, 0.12)
    assert ctx.k_max == 80 and any("max degree 79" in str(w.message) for w in seen)


def test_sparse_gcn_matches_dense_forward_and_gradients():
    cache = _cache()
    d, s = build_graph_context(cache, 0.12), build_sparse_graph_context(cache, 0.12)
    torch.manual_seed(0)
    gcn = SimpleGCN(416, 64, 32, dropout=0.0)
    rows = torch.tensor([3, 17, 3, 40])
    ax = torch.from_numpy(d.ax)
    idx, w = torch.from_numpy(s.nbr_idx).long(), torch.from_numpy(s.nbr_w)

    def grads(z):
        return torch.autograd.grad((z ** 2).sum(), list(gcn.parameters()))

    zd = gcn.propagate(torch.from_numpy(d.a_norm)[rows], ax)
    zs = gcn.propagate_sparse(idx[rows], w[rows], torch.from_numpy(s.ax))
    torch.testing.assert_close(zs, zd, rtol=1e-5, atol=1e-6)
    for gs, gd in zip(grads(zs), grads(zd)):
        torch.testing.assert_close(gs, gd, rtol=2e-4, atol=1e-6)
    # new nodes: (B, K) link lists against (B, N) rows
    with torch.no_grad():
        h = gcn.corpus_hidden(ax)
        xg = torch.from_numpy(d.xg)
        a_rows = torch.zeros(2, len(cache["labels"]))
        new_idx = torch.tensor([[5, 9, 0], [7, 0, 0]])
        new_w = torch.tensor([[0.2, 0.1, 0.0], [0.3, 0.0, 0.0]])
        for i in range(2):
            a_rows[i, new_idx[i]] += new_w[i]
        self_w, x_new = torch.tensor([0.5, 0.6]), xg[:2] * 0.5
        torch.testing.assert_close(gcn.extend_sparse(new_idx, new_w, self_w, x_new, xg, h),
                                   gcn.extend(a_rows, self_w, x_new, xg, h),
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_sparse(fixture_data_root, tmp_path_factory):
    from ultrafnd_git_tpu.training.trainer import ForensicTrainer, TrainConfig

    out = tmp_path_factory.mktemp("jax_sparse")
    cfg = TrainConfig(data_root=fixture_data_root, out_dir=str(out), batch_size=8, epochs=1,
                      seed=0, sparse_graph=True, log_metrics_jsonl=False)
    return ForensicTrainer(cfg)


@pytest.fixture(scope="module")
def bridged(jax_sparse, tmp_path_factory):
    """A port trainer under sparse_graph, on the JAX trainer's cache, carrying
    its initial params (after the GCN pretrain)."""
    from ultrafnd_git_tpu_torch.data.cache import load_cache

    cache = load_cache(os.path.join(jax_sparse.cfg.out_dir, "feature_cache.npz"))
    pt = port.ForensicTrainer(port.TrainConfig(
        out_dir=str(tmp_path_factory.mktemp("port_sparse")), batch_size=8, epochs=1, seed=0,
        sparse_graph=True), cache=cache, device="cpu")
    assert "a_norm" not in pt.corpus and pt.corpus["nbr_idx"].dtype == torch.int64
    sds = port_state_dicts(jax.device_get(jax_sparse.state.params), None, node_tau=10.0)
    for part, mod in pt.state.params.items():
        mod.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sds[part].items()})
    return pt


def test_sparse_training_gradient_matches_jax(jax_sparse, bridged):
    jt = jax_sparse
    np.testing.assert_array_equal(bridged.corpus["nbr_idx"].numpy(), np.asarray(jt.NBR_IDX))
    idx = np.asarray(jt.tr_idx[:8], np.int32).copy()
    idx[5:] = idx[4]
    mask = (np.arange(8) < 5).astype(np.float32)

    def loss_fn(params):
        ce, _, _ = jt._forward(params, jnp.asarray(idx), jt.corpus, deterministic=True)
        return (ce * mask).sum() / mask.sum()

    loss_ref, g = jax.jit(jax.value_and_grad(loss_fn))(jt.state.params)
    ref = port_state_dicts(jax.device_get(g), None, node_tau=10.0)
    loss, grads, _ = bridged.grads_of(torch.from_numpy(idx).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(loss_ref), **TOL)
    assert set(grads) == {"fusion", "clf", "gnn"}
    for part, leaves in grads.items():
        for name, gv in leaves.items():
            np.testing.assert_allclose(gv.numpy(), np.asarray(ref[part][name]),
                                       err_msg=f"{part}.{name}", **TOL)


def test_sparse_pretrain_gradient_matches_jax(jax_sparse, bridged):
    jt = jax_sparse
    head = (np.random.default_rng(7).standard_normal((128, 1)) / np.sqrt(128)).astype(np.float32)

    def loss_fn(p):  # _pretrain_gnn's loss with the sparse degree target, dropout off
        z = jt.gnn.apply({"params": p}, jt.XG, None, deterministic=True, normalize=False,
                         ax=jt.AX, nbr_idx=jt.NBR_IDX, nbr_w=jt.NBR_W)
        target = jt.NBR_W.sum(axis=-1, keepdims=True) / max(1.0, float(jt.n_total))
        return jnp.mean((jax.nn.sigmoid(z @ head) - target) ** 2)

    loss_ref, g_ref = jax.value_and_grad(loss_fn)(jt.state.params["gnn"])
    gnn = bridged.state.params["gnn"]
    loss = bridged.pretrain_loss(gnn, torch.from_numpy(head))
    grads = torch.autograd.grad(loss, list(gnn.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), **TOL)
    ref = port_state_dicts({"fusion": jt.state.params["fusion"], "clf": jt.state.params["clf"],
                            "gnn": jax.device_get(g_ref)}, None, 10.0)["gnn"]
    for (name, _), gv in zip(gnn.named_parameters(), grads):
        np.testing.assert_allclose(gv.numpy(), np.asarray(ref[name]), err_msg=name, **TOL)


def test_sparse_checkpoint_serves_through_both_layouts(bridged, tmp_path):
    from ultrafnd_git_tpu_torch.serving import Predictor, write_seeded_model_dir
    from ultrafnd_git_tpu_torch.utils.transfer import export_trained

    bridged.fit()
    run = bridged.cfg.out_dir
    saved = json.loads(open(os.path.join(run, "best", "meta.json")).read())
    meta = {"cfg": saved["cfg"], **saved["model"], "align": {"in_dim": 768, "out_dim": 256}}
    align_dir = write_seeded_model_dir(str(tmp_path / "align"), meta, bridged.cache)
    served = export_trained(run, "best", str(tmp_path / "served"), str(align_dir))
    assert json.loads((served / "meta.json").read_text())["cfg"]["sparse_graph"] is True
    recs = [{"video_id": f"q{i}", "title": "警告 危险 外星人", "ocr": ocr, "comments": ["评论"]}
            for i, ocr in enumerate(["飞船 出现", "", " ".join(sorted(bridged.cache["ocr_sets"][3]))])]
    rows = {}
    for layout in (None, False):
        pred = Predictor(str(served), batch_size=8, device="cpu", sparse_graph=layout)
        try:
            assert pred.sparse_graph is (layout is None)
            assert hasattr(pred, "NBR_IDX") is (layout is None)
            rows[layout] = pred.predict(recs)
            bg = pred._explain_background(8)
            ex = pred.explain(recs[:1], method="grad", top_k=4)
        finally:
            pred.close()
        rows[layout].append(bg)
        assert len(ex[0]["explain"]["top_fused_dims"]) == 4
    (*sparse, bg_s), (*dense, bg_d) = rows[None], rows[False]
    for rs, rd in zip(sparse, dense):
        assert rs["id"] == rd["id"] and 0.0 <= rs["prob_fake"] <= 1.0
        for key in ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity"):
            assert abs(rs[key] - rd[key]) < 1e-5, key
    np.testing.assert_allclose(bg_s, bg_d, atol=1e-5)


def test_train_cli_takes_sparse_graph():
    from ultrafnd_git_tpu_torch.train import parse_args

    assert parse_args(["--sparse_graph"]).sparse_graph is True
    assert parse_args([]).sparse_graph is False


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_weighted_edges_at_zero_threshold_drop_zero_weights(use_native, monkeypatch):
    """With weighted=True and thresh <= 0 both paths list only pairs that
    share a token (the JAX numpy path also lists zero-weight pairs)."""
    if not use_native:
        monkeypatch.setenv("ULTRAFND_NATIVE", "0")
    sets = _random_sets(40, seed=3)
    src, dst, w = build_edges_from_ocr(sets, 0.0, weighted=True)
    assert len(w) and (w > 0).all()
    ref = jax_edges(sets, 0.0, weighted=True)
    keep = ref[2] > 0
    for a, b in zip((src, dst, w), ref):
        np.testing.assert_array_equal(a, b[keep])
