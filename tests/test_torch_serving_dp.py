"""PyTorch port, `Predictor(serve_dp=N)` against the single Predictor and
the JAX package's `serve_dp` Predictor (`tests/test_serving_mesh.py`), on
the shared --train_text_tower checkpoint exported to a model directory.

On the CPU the N replicas are the CPU and the row blocks run in turn: 13
records (two chunks of batch_size 8) and 5 (one) have buckets of 8, each
cut into 8 blocks, one scoring program call each, and their rows are the
single Predictor's within 1e-6
(JAX's `_assert_rows_equal`); 3 records at batch_size 4 (bucket 4, which 8
does not divide) are scored whole, equal to the single Predictor's. The
JAX Predictor with serve_dp=8 on the conftest's 8 virtual CPU devices
agrees within 1e-4 in prob_fake. explain() takes the same split. On CUDA,
fewer cards than serve_dp raise JAX's ValueError; the --serve_dp flags of
predict and serve. A switch-MoE tower at serve_dp is held to the single
and the JAX Predictor in tests/test_torch_moe_serving.py.
"""
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from ultrafnd_git_tpu_torch import serving
from ultrafnd_git_tpu_torch.serving import Predictor

REPO = Path(__file__).resolve().parents[1]
KEYS = ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity")
DP = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side of these tests runs small tensors, which one thread
    computes faster than a pool that parallel test workers oversubscribe;
    the previous count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_rows_equal(got, want, atol=1e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["id"] == w["id"]
        assert g["label"] == w["label"]
        for k in KEYS:
            np.testing.assert_allclose(g[k], w[k], atol=atol, err_msg=k)


def _records(n):
    pool = [
        ("外星人 入侵 地球 警告 危险", "外星 飞船 出现 危险 逃离"),
        ("辟谣 外星人 谣言 不实", "专家 辟谣 谣言 证据 科学"),
        ("普通 新闻 报道 今天", "今天 天气 晴朗"),
    ]
    return [{"video_id": f"m{i}", "title": pool[i % 3][0], "ocr": pool[i % 3][1],
             "comments": ["评论"] if i % 2 else []} for i in range(n)]


@pytest.fixture(scope="module")
def exported(tower_ckpt, tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    model_dir = tmp_path_factory.mktemp("serve_dp_model")
    mod.export(tower_ckpt["out"], str(model_dir))
    yield str(model_dir)
    shutil.rmtree(model_dir, ignore_errors=True)


@pytest.fixture(scope="module")
def predictors(exported):
    return {(dp, b): Predictor(exported, batch_size=b, device="cpu", serve_dp=dp)
            for dp in (None, DP) for b in (8, 4)}


def _calls(monkeypatch):
    """The scoring programs' first-stage calls, counted."""
    calls = []
    features = serving.ScoringProgram.features

    def counted(self, x):
        calls.append(int(next(iter(x.values())).shape[0]))
        return features(self, x)

    monkeypatch.setattr(serving.ScoringProgram, "features", counted)
    return calls


@pytest.mark.parametrize("n,batch,blocks", [(13, 8, DP), (5, 8, DP), (3, 4, 1)])
def test_serve_dp_rows_equal_the_single_predictor(predictors, monkeypatch, n, batch, blocks):
    multi, single = predictors[(DP, batch)], predictors[(None, batch)]
    assert multi.replicas == [torch.device("cpu")] * DP and len(single.replicas) == 1
    want = single.predict(_records(n))
    calls = _calls(monkeypatch)
    got = multi.predict(_records(n))
    chunks = -(-n // batch)  # the CPU dispatches chunks of batch_size rows, bucket batch_size
    assert calls == [batch // blocks] * blocks * chunks  # each row block through a program
    if blocks == 1:  # the whole bucket on replica 0: the single Predictor's program
        assert got == want
    else:
        _assert_rows_equal(got, want)


def test_serve_dp_matches_the_jax_serve_dp_predictor(predictors, tower_ckpt):
    import jax

    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    assert len(jax.devices()) >= DP
    ref = JaxPredictor(tower_ckpt["out"], batch_size=8, serve_dp=DP).predict(_records(13))
    got = predictors[(DP, 8)].predict(_records(13))
    assert [r["id"] for r in got] == [r["id"] for r in ref]
    np.testing.assert_allclose([r["prob_fake"] for r in got], [r["prob_fake"] for r in ref],
                               atol=1e-4)


def test_explain_takes_the_same_split(predictors, monkeypatch):
    want = predictors[(None, 8)].explain(_records(5), method="grad")
    calls = _calls(monkeypatch)
    got = predictors[(DP, 8)].explain(_records(5), method="grad")
    assert calls == [1] * DP
    _assert_rows_equal(got, want)
    for g, w in zip(got, want):
        np.testing.assert_allclose([v for _, v in g["explain"]["top_fused_dims"]],
                                   [v for _, v in w["explain"]["top_fused_dims"]], atol=1e-6)


def test_serve_dp_rejects_oversubscription(exported, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="serve_dp=2 but only 1 device\\(s\\) visible"):
        Predictor(exported, batch_size=8, serve_dp=2)


def test_serve_dp_cli_flags(exported, predictors, tmp_path, monkeypatch):
    from ultrafnd_git_tpu_torch import predict, serve

    path = tmp_path / "records.json"
    path.write_text(json.dumps(_records(13), ensure_ascii=False), encoding="utf-8")
    out = tmp_path / "rows.jsonl"
    predict.main(["--model_dir", exported, "--input", str(path), "--output", str(out),
                  "--batch_size", "8", "--device", "cpu", "--serve_dp", str(DP)])
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    _assert_rows_equal(rows, predictors[(None, 8)].predict(_records(13)))
    args = serve.parse_args(["--model_dir", exported, "--cpu", "--serve_dp", "2"])
    assert args.serve_dp == 2
    made = {}
    monkeypatch.setattr(serving, "Predictor", lambda *a, **kw: made.update(kw))
    predict.make_predictor(args)  # serve's Predictor, as serve.main builds it
    assert made["serve_dp"] == 2 and made["device"] == "cpu"
