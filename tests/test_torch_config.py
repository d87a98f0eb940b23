"""PyTorch port: `fusion_config` / `classifier_config` read as the JAX
trainers read them.

The port reads flat YAML without PyYAML (`utils/config.py`); the JAX
package reads it with PyYAML through `ConfigManager`. Both trainers of each
package build their fusion and classifier from the two files: a YAML that
sets `hidden_dim: 256` gives a 256-wide fusion in both, the JAX params load
into the port's modules, the port's slots record the dims, and its
Predictor serves them. The shipped files give the dims the port had
before it read them.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu_torch.data import cache as port_cache
from ultrafnd_git_tpu_torch.data.dataset import FakeSVRawDataset
from ultrafnd_git_tpu_torch.utils import transfer
from ultrafnd_git_tpu_torch.utils.config import (
    classifier_config,
    fusion_config,
    load_flat_yaml,
)

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "tests" / "fixtures" / "fakesv_tiny")
FUSION_256 = "# a wider fusion\nhidden_dim: 256   # was 512\ndropout: 0.2\n\nuse_gnn: true\n"
CLF_128 = "hidden_dim: 128\nnode_trees: 3\nnode_depth: 2\ntemperature: 1.5\n"


@pytest.mark.parametrize("text,expected", [
    ("a: 1\nb: -2.5\nc: true\nd: No\ne: ~\n", {"a": 1, "b": -2.5, "c": True, "d": False,
                                                "e": None}),
    ("# only a comment\n\n", {}),
    ("lr: 1e-4\nname: 'x # y'\nnote: \"q\"\n", {"lr": "1e-4", "name": "x # y", "note": "q"}),
    ("hidden_dim: 512   # trailing\n---\nuse_gnn: off\n", {"hidden_dim": 512, "use_gnn": False}),
    ("tag: a#b\nk_2.v-3: 1_000\n", {"tag": "a#b", "k_2.v-3": 1000}),
], ids=["scalars", "comments_only", "strings", "trailing_comment", "names"])
def test_flat_yaml_reader(tmp_path, text, expected):
    p = tmp_path / "c.yaml"
    p.write_text(text, encoding="utf-8")
    assert load_flat_yaml(str(p)) == expected


@pytest.mark.parametrize("text", [
    "model:\n  hidden_dim: 512\n",  # nested
    "- 1\n- 2\n",  # a list
    "dims: [1, 2]\n",  # a flow collection
    "a: {b: 1}\n",
    "just text\n",
    "a: 1\na: 2\n",
    "a: 'open\n",
], ids=["nested", "list", "flow_list", "flow_map", "no_colon", "twice", "open_quote"])
def test_flat_yaml_refuses_what_is_not_flat(tmp_path, text):
    p = tmp_path / "c.yaml"
    p.write_text(text, encoding="utf-8")
    with pytest.raises(ValueError):
        load_flat_yaml(str(p))


def test_missing_file_defaults_and_repo_root(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # relative paths resolve against the repo root
    assert load_flat_yaml("configs/model_configs/fusion.yaml")["hidden_dim"] == 512
    assert load_flat_yaml("configs/model_configs/none.yaml") == {}
    assert fusion_config("missing.yaml") == {"hidden": 512, "dropout": 0.1, "use_gnn": True}


def test_shipped_configs_are_jaxs_and_todays():
    """The shipped YAMLs through the port's reader give the JAX modules'
    from_config values, and the dims the port built before reading them."""
    from ultrafnd_git_tpu.models.classifier import DeepTruthClassifier
    from ultrafnd_git_tpu.models.fusion import CrossModalTransformer

    f, c = fusion_config(), classifier_config()
    jf, jc = CrossModalTransformer.from_config(), DeepTruthClassifier.from_config()
    assert f == {"hidden": jf.hidden, "dropout": jf.dropout, "use_gnn": jf.use_gnn}
    assert c == {k: getattr(jc, k) for k in c}
    assert f == {"hidden": 512, "dropout": 0.1, "use_gnn": True}
    assert c == dict(hidden=512, dropout=0.1, num_classes=2, use_aux=True, aux_dim=2,
                     node_trees=6, node_depth=4, node_tau=10.0, node_dropout=0.3,
                     temperature_init=1.0)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    root = tmp_path_factory.mktemp("yaml")
    (root / "fusion.yaml").write_text(FUSION_256, encoding="utf-8")
    (root / "classifier.yaml").write_text(CLF_128, encoding="utf-8")
    return {"fusion_config": str(root / "fusion.yaml"),
            "classifier_config": str(root / "classifier.yaml")}


@pytest.fixture(scope="module")
def cache():
    return port_cache.build_feature_cache(
        FakeSVRawDataset(TINY), seed=0, with_evidence=False,
        encoders=port_cache.make_encoders(seed=0, with_evidence=False, device="cpu"))


def _load_jax_params(port_params, jax_params):
    """The JAX fusion and classifier params into the port's modules (strict)."""
    sds = {"fusion": transfer.fusion_state_dict(jax_params["fusion"]),
           "clf": transfer.classifier_state_dict_from_params(jax_params["clf"], tau=10.0)}
    for part, sd in sds.items():
        port_params[part].load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()})


@pytest.mark.parametrize("kind", ["v2", "integrated"])
def test_yaml_dims_train_in_both_packages(configs, cache, tmp_path, kind):
    if kind == "v2":
        from ultrafnd_git_tpu.training.trainer import ForensicTrainer as JaxTrainer
        from ultrafnd_git_tpu.training.trainer import TrainConfig as JaxCfg
        from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig
    else:
        from ultrafnd_git_tpu.training.trainer_integrated import (
            IntegratedForensicTrainer as JaxTrainer,
        )
        from ultrafnd_git_tpu.training.trainer_integrated import (
            IntegratedTrainConfig as JaxCfg,
        )
        from ultrafnd_git_tpu_torch.training.trainer_integrated import (
            IntegratedForensicTrainer as ForensicTrainer,
        )
        from ultrafnd_git_tpu_torch.training.trainer_integrated import (
            IntegratedTrainConfig as TrainConfig,
        )
    kw = dict(data_root=TINY, batch_size=8, epochs=1, seed=0, cache_to_disk=False,
              log_metrics_jsonl=False, **configs)
    jt = JaxTrainer(JaxCfg(out_dir=str(tmp_path / "jax"), **kw), cache=dict(cache))
    params = jax.device_get(jt.state.params)
    assert np.asarray(params["fusion"]["text_proj"]["kernel"]).shape == (768, 256)
    assert np.asarray(params["clf"]["pre0"]["kernel"]).shape == (258, 128)
    assert np.asarray(params["clf"]["node"]["gates"]).shape[:2] == (3, 2)

    pt = ForensicTrainer(TrainConfig(out_dir=str(tmp_path / "port"), **kw), cache=dict(cache),
                         device="cpu")
    assert pt.state.params["fusion"].text_proj.weight.shape == (256, 768)
    _load_jax_params(pt.state.params, params)
    if kind == "v2":
        pt.fit()
    else:
        pt.train()
    meta = json.loads((tmp_path / "port" / "best" / "meta.json").read_text())
    assert meta["model"]["fusion"]["hidden"] == 256
    assert meta["model"]["classifier"]["hidden"] == 128
    assert meta["model"]["classifier"]["node_trees"] == 3
    if kind == "v2":  # the Predictor builds its modules from the slot's dims
        from ultrafnd_git_tpu_torch.serving import Predictor

        port_cache.save_cache(cache, str(tmp_path / "port" / "feature_cache.npz"))
        port_cache.save_align(str(tmp_path / "port"), *_align())
        pred = Predictor(out_dir=str(tmp_path / "port"), device="cpu")
        try:
            rows = pred.predict([{"title": "外星人 警告", "ocr": "", "comments": []}])
        finally:
            pred.close()
        assert pred.modules["fusion"].text_proj.weight.shape == (256, 768)
        assert np.isfinite(rows[0]["prob_fake"])


def _align():
    """The align MLP the cache fixture was built with (seed 0)."""
    tsync = port_cache.make_encoders(seed=0, with_evidence=False, device="cpu")["tsync"]
    return tsync.module.state_dict(), tsync.in_dim, tsync.out_dim
