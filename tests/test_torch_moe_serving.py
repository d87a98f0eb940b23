"""PyTorch port, a switch-MoE checkpoint through the weight bridge and the
Predictor, against the JAX package on the CPU.

A JAX out_dir with a MoE tower (`--moe_experts 2`, depth 1, 4 heads, the
fixture's 768-wide text, its initial parameters saved as the `best` slot)
goes through `scripts/export_torch_model.py` and is served by the port's
`Predictor`. Before the scores are compared, the expert and slot of every
token of the served bucket must equal the JAX tower's on the same ids,
whose smallest top-1 / top-2 router margin must exceed 1e-5 (the test
asserts both). Tolerances: prob_fake and the forensic keys within 1e-4 of
the JAX `Predictor`'s; explain(grad) runs through the MoE tower. int8 quantizes the
same leaves as JAX's `quantize_tree` on a MoE tree: at E = 8 and width 768
the router's 2-D kernel (6144 >= min_size 4096) is quantized, with values
and scales equal to JAX's, and the 3-D expert arrays stay f32. At serve_dp=2 (CPU replicas) every
bucket is scored whole, as JAX's sharded program routes it: the rows equal
the single Predictor's, the routes are the JAX tower's, and the rows agree
with JAX's serve_dp=2 Predictor within 1e-4; explain() takes the same route.
"""
import importlib.util
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_moe import MARGIN, _jax_route, _port_routes, one_torch_thread  # noqa: F401
from ultrafnd_git_tpu.ops import hashing as jax_hashing
from ultrafnd_git_tpu.ops.quant import QKEY, SKEY, quantize_tree
from ultrafnd_git_tpu_torch.models.moe import MoEFFN
from ultrafnd_git_tpu_torch.models.transformer import TextTransformer
from ultrafnd_git_tpu_torch.ops import hashing as port_hashing
from ultrafnd_git_tpu_torch.ops import quant
from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.serving import Predictor

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny"
KEYS = ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity")
ATOL = 1e-4
SERVE_DP = 2


@pytest.fixture(autouse=True)
def _keep_salts():
    prev = port_hashing.get_hash_salt(), jax_hashing.get_hash_salt()
    yield
    port_hashing.set_hash_salt(prev[0])
    jax_hashing.set_hash_salt(prev[1])


@pytest.fixture(scope="module")
def moe_dirs(tmp_path_factory):
    """(JAX out_dir, the port's export of it), removed after the module."""
    from dataclasses import asdict

    from ultrafnd_git_tpu.training import checkpoint as jax_ckpt
    from ultrafnd_git_tpu.training.trainer import ForensicTrainer, TrainConfig

    out = tmp_path_factory.mktemp("jax_moe")
    cfg = TrainConfig(data_root=str(FIXTURE), out_dir=str(out), batch_size=8, epochs=1, seed=0,
                      log_metrics_jsonl=False, train_text_tower=True, text_tower_depth=1,
                      text_tower_heads=4, moe_experts=2)
    jt = ForensicTrainer(cfg)
    jax_ckpt.save_checkpoint(str(out), "best", jt.state,
                             {"trainer": "v2", "epoch": 1, "best_val_auc": 0.5,
                              "no_improve": 0, "cfg": asdict(cfg)})
    jax_ckpt.wait_for_writes()
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    model = tmp_path_factory.mktemp("torch_moe")
    mod.export(str(out), str(model))
    yield str(out), str(model)
    for root in (out, model):  # a JAX slot and an export of about 0.7 GB
        shutil.rmtree(root, ignore_errors=True)


def test_export_records_the_moe_tower(moe_dirs):
    meta = json.loads((Path(moe_dirs[1]) / "meta.json").read_text())
    assert meta["text_tower"]["moe_experts"] == 2
    assert meta["text_tower"]["moe_capacity_factor"] == 1.25
    weights = torch.load(Path(moe_dirs[1]) / "weights.pt", weights_only=True)
    tower = weights["text_tower"]
    assert tower["blocks.0.moe.w_in"].shape == (2, 768, 3072)
    assert tower["blocks.0.moe.router.weight"].shape == (2, 768)
    assert not any("mlp_in" in k for k in tower)


def _predict_holding_routes(pp, jp, records):
    """pp.predict(records), with the expert and slot of every token of
    each bucket the port's tower routes held to the JAX tower's on the same
    ids (and its smallest top-1 / top-2 margin above MARGIN)."""
    tower = pp.text_tower
    assert isinstance(tower, TextTransformer) and tower.moe_experts == 2
    inputs = []
    hook = tower.register_forward_pre_hook(lambda m, args: inputs.append(args))
    routes, handles = _port_routes(tower)
    try:
        rows = pp.predict(records)
    finally:
        hook.remove()
        for h in handles:
            h.remove()
    # on the CPU a chunk is batch_size rows: 16 records, then 4 in a 16-row bucket
    assert [tuple(a[0].shape) for a in inputs] == [(16, 64)] * 2 and len(routes) == 2
    for (ids, mask), (expert, slot, cap) in zip(inputs, routes):
        _, state = jp.text_tower.apply({"params": jp.params["text_tower"]},
                                       jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()),
                                       deterministic=True,
                                       capture_intermediates=lambda m, n: m.name == "router",
                                       mutable=["intermediates"])
        logits = np.asarray(state["intermediates"]["block0"]["moe"]["router"]["__call__"][0])
        j_expert, j_slot, margin, _ = _jax_route(logits, cap)
        assert margin > MARGIN, margin
        np.testing.assert_array_equal(expert, j_expert)
        np.testing.assert_array_equal(slot, j_slot)
    return rows


def test_moe_checkpoint_served_by_the_port_matches_jax(moe_dirs):
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    records = load_records(str(FIXTURE / "data_complete.json"))[:20]
    jp = JaxPredictor(moe_dirs[0], batch_size=16)
    pp = Predictor(moe_dirs[1], batch_size=16, device="cpu")
    rows = _predict_holding_routes(pp, jp, records)

    ref = jp.predict(records)
    assert [r["id"] for r in rows] == [r["id"] for r in ref]
    for key in KEYS:
        np.testing.assert_allclose([r[key] for r in rows], [r[key] for r in ref],
                                   atol=ATOL, rtol=0, err_msg=key)
    explained = pp.explain(records[:4], method="grad")
    assert all(np.isfinite(r["explain"]["fused_attr_l1"]) for r in explained)


@pytest.fixture(scope="module")
def serve_dp_predictors(moe_dirs):
    """The MoE export served by the port at serve_dp 1 and 2 (CPU replicas)."""
    made = {dp: Predictor(moe_dirs[1], batch_size=16, device="cpu", serve_dp=dp)
            for dp in (None, SERVE_DP)}
    yield made
    for p in made.values():
        p.close()


def test_serve_dp_scores_a_moe_tower_whole_as_the_single_predictor(serve_dp_predictors,
                                                                  monkeypatch):
    """serve_dp=2 scores every bucket whole on replica 0 (16 rows, which
    2 divides, in one program call a chunk): the capacity and the slot order
    are the whole bucket's, so the rows equal the single Predictor's."""
    from ultrafnd_git_tpu_torch import serving

    records = load_records(str(FIXTURE / "data_complete.json"))[:20]
    multi = serve_dp_predictors[SERVE_DP]
    assert multi.replicas == [torch.device("cpu")] * SERVE_DP
    want = serve_dp_predictors[None].predict(records)
    calls = []
    features = serving.ScoringProgram.features

    def counted(self, x):
        calls.append(int(x["text_ids"].shape[0]))
        return features(self, x)

    monkeypatch.setattr(serving.ScoringProgram, "features", counted)
    assert multi.predict(records) == want
    assert calls == [16, 16]


def test_serve_dp_moe_rows_match_jax_serve_dp(serve_dp_predictors, moe_dirs):
    """The JAX Predictor at serve_dp=2 on the conftest's virtual CPU devices
    routes the whole bucket as one device does; the port's serve_dp=2 rows,
    its routes held to the JAX tower's, agree with it within 1e-4."""
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    assert len(jax.devices()) >= SERVE_DP
    records = load_records(str(FIXTURE / "data_complete.json"))[:20]
    jp = JaxPredictor(moe_dirs[0], batch_size=16, serve_dp=SERVE_DP)
    ref = jp.predict(records)
    rows = _predict_holding_routes(serve_dp_predictors[SERVE_DP], jp, records)
    assert [r["id"] for r in rows] == [r["id"] for r in ref]
    for key in KEYS:
        np.testing.assert_allclose([r[key] for r in rows], [r[key] for r in ref],
                                   atol=ATOL, rtol=0, err_msg=key)


def test_serve_dp_moe_explain_takes_the_same_route(serve_dp_predictors):
    records = load_records(str(FIXTURE / "data_complete.json"))[:4]
    want = serve_dp_predictors[None].explain(records, method="grad")
    assert serve_dp_predictors[SERVE_DP].explain(records, method="grad") == want


def test_int8_quantizes_the_jax_leaves_of_a_moe_ffn_router_included():
    from ultrafnd_git_tpu.models.moe import MoEFFN as JaxMoEFFN

    e, w = 8, 768
    jm = JaxMoEFFN(w, num_experts=e)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, w)))["params"])
    qtree, jstats = quantize_tree(params)
    ffn = MoEFFN(w, e)
    ffn.load_state_dict({
        "router.weight": torch.tensor(np.asarray(params["router"]["kernel"]).T),
        "router.bias": torch.tensor(np.asarray(params["router"]["bias"])),
        **{k: torch.tensor(np.asarray(params[k])) for k in ("w_in", "b_in", "w_out", "b_out")},
    })
    wrapper = torch.nn.ModuleDict({"moe": ffn})
    stats = quant.quantize_modules(wrapper)
    assert stats == jstats == {"quantized": 1, "kept": 5}
    router = wrapper["moe"].router
    assert isinstance(router, quant.QuantDense)
    np.testing.assert_array_equal(router.weight_q.numpy(), np.asarray(qtree["router"]["kernel"][QKEY]).T)
    np.testing.assert_array_equal(router.weight_scale.numpy(),
                                  np.asarray(qtree["router"]["kernel"][SKEY]).T)
    for k in ("w_in", "b_in", "w_out", "b_out"):
        assert getattr(wrapper["moe"], k).dtype == torch.float32
        assert not isinstance(qtree[k], dict)
    x = torch.randn(2, 4, w)
    y, _ = wrapper["moe"](x)  # the quantized router still routes, in f32
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_moe_export_is_refused_as_jax_refuses_it(moe_dirs, tmp_path):
    """A frozen artifact takes one symbolic batch dimension; the MoE
    capacity is a Python int of the call's token count (JAX
    `models/moe.py:59`), so JAX's `export_artifact` fails at that line and
    the port's `export_artifact` refuses the tower with the same reason."""
    import traceback

    from ultrafnd_git_tpu.export_serving import export_artifact as jax_export
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor
    from ultrafnd_git_tpu_torch.export_serving import export_artifact

    with pytest.raises(Exception) as err:
        jax_export(JaxPredictor(moe_dirs[0], batch_size=8), str(tmp_path / "jax"),
                   platforms=("cpu",))
    frames = traceback.extract_tb(err.value.__traceback__)
    assert any(f.filename.endswith("ultrafnd_git_tpu/models/moe.py") and f.lineno == 59
               for f in frames), [f"{f.filename}:{f.lineno}" for f in frames][-5:]
    pred = Predictor(moe_dirs[1], batch_size=8, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="capacity"):
            export_artifact(pred, str(tmp_path / "port"), platforms=("cpu",))
    finally:
        pred.close()
    assert not (tmp_path / "port").exists()
