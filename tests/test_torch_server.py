"""PyTorch port, HTTP serving (`ultrafnd_git_tpu_torch/server.py`): the port's
counterparts of tests/test_server.py, a live ThreadingHTTPServer over the
port's Predictor on the exported tower checkpoint (CPU).

/healthz, /stats, /predict equal to the library's rows, /explain, error
paths that leave the server up, dynamic batching exact and coalesced, the
server's rows against the JAX Predictor's within 1e-4, and the serve CLI in
a fresh process that loads no module of jax or of ultrafnd_git_tpu (its
`--device cuda` default raising without a GPU).
"""
import importlib.util
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.server import make_server
from ultrafnd_git_tpu_torch.serving import Predictor

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny" / "data_complete.json"
RECORDS = [
    {"video_id": "h_fake", "title": "外星人 入侵 地球 警告 危险",
     "ocr": "外星 飞船 出现 危险 逃离", "comments": ["太可怕了 赶紧转发"]},
    {"video_id": "h_real", "title": "辟谣 外星人 谣言 不实",
     "ocr": "专家 辟谣 谣言 证据 科学", "comments": ["官方已经辟谣了"]},
]


@pytest.fixture(scope="module")
def exported(tower_ckpt, tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("torch_model")
    mod.export(tower_ckpt["out"], str(out))
    return str(out)


def _serve(predictor, **kw):
    server = make_server(predictor, port=0, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    if server.batcher is not None:
        server.batcher.close()
    thread.join(timeout=5)


@pytest.fixture(scope="module")
def live_server(exported):
    predictor = Predictor(exported, batch_size=4, device="cpu")
    server, thread, url = _serve(predictor)
    yield {"url": url, "server": server, "predictor": predictor}
    _stop(server, thread)
    predictor.close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode("utf-8"),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_healthz_reports_the_torch_device(live_server):
    status, body = _get(f"{live_server['url']}/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["backend"] == "cpu" and body["device"] == "cpu" and body["device_name"] == "cpu"


def test_stats_endpoint_reports_batcher_efficiency(live_server):
    url = live_server["url"]
    status, _ = _post(f"{url}/predict", {"records": RECORDS})
    assert status == 200
    status, body = _get(f"{url}/stats")
    assert status == 200 and body["requests"] >= 1 and body["records_served"] >= 2
    b = body["batcher"]
    assert b["dispatches"] >= 1 and b["records"] >= 2 and b["avg_records_per_dispatch"] >= 1
    assert b["queued_records"] == 0 and b["max_batch"] == 4096


def test_predict_endpoint_matches_library_and_jax(live_server, tower_ckpt):
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    records = load_records(FIXTURE)[:20]
    status, body = _post(f"{live_server['url']}/predict", {"records": records})
    assert status == 200
    preds = body["predictions"]
    pred = live_server["predictor"]
    # one window, one dispatch: the library's predict_featurized to the bit
    assert preds == pred.predict_featurized(pred.featurize(records), len(records))
    # predict() cuts the request into chunks of batch_size rows (on the CPU)
    direct = pred.predict(records)
    assert [p["id"] for p in preds] == [r["id"] for r in direct]
    assert max(abs(p["prob_fake"] - r["prob_fake"]) for p, r in zip(preds, direct)) < 1e-5
    ref = JaxPredictor(tower_ckpt["out"]).predict(records)
    assert [p["id"] for p in preds] == [r["id"] for r in ref]
    for key in ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity"):
        np.testing.assert_allclose([p[key] for p in preds], [r[key] for r in ref], atol=1e-4,
                                   err_msg=key)


def test_explain_endpoint(live_server):
    status, body = _post(f"{live_server['url']}/explain",
                         {"records": RECORDS[:1], "method": "grad", "top_k": 2})
    assert status == 200
    [p] = body["predictions"]
    assert p["explain"]["method"] == "grad_x_input" and len(p["explain"]["top_fused_dims"]) == 2
    status, body = _post(f"{live_server['url']}/explain",
                         {"records": RECORDS[:1], "method": "shap", "top_k": 2,
                          "n_coalitions": 32, "background_size": 4})
    assert status == 200 and body["predictions"][0]["explain"]["method"] == "kernel-shap"


def test_error_paths_stay_up(live_server):
    url = live_server["url"]
    for data in (b"not json{", b"[1, 2]"):  # malformed JSON, JSON that is not an object
        req = urllib.request.Request(f"{url}/predict", data=data,
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
    status, body = _post(f"{url}/predict", {"records": "nope"})
    assert status == 400 and "error" in body
    status, body = _post(f"{url}/explain", {"records": RECORDS, "method": "lime"})
    assert status == 400 and "error" in body
    status, body = _post(f"{url}/explain", {"records": RECORDS[:1], "method": "shap",
                                            "background_size": 0})
    assert status == 400 and "background_size" in body["error"]
    status, body = _post(f"{url}/explain", {"records": RECORDS[:1], "method": "shap",
                                            "n_coalitions": {"x": 1}})
    assert status == 400 and "error" in body
    status, body = _post(f"{url}/nope", {"records": []})
    assert status == 404
    status, body = _get(f"{url}/healthz")
    assert body["status"] == "ok" and body["requests"] >= 2


def test_dynamic_batching_exact_and_coalesced(live_server):
    """Concurrent one-record requests coalesce into fewer dispatches and each
    caller gets the row it would have got alone."""
    predictor = live_server["predictor"]
    recs = [{"video_id": f"r{i}", "title": f"警告 危险 外星 入侵 {i}",
             "ocr": f"飞船 出现 逃离 {i}", "comments": [f"c{i}"]} for i in range(8)]
    server, thread, url = _serve(predictor, batch_window_ms=300.0)
    try:
        results = [None] * len(recs)
        barrier = threading.Barrier(len(recs))

        def call(i):
            barrier.wait(timeout=60)
            results[i] = _post(f"{url}/predict", {"records": [recs[i]]})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(recs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        direct = predictor.predict(recs)
        window = predictor.predict_featurized(predictor.featurize(recs), len(recs))
        one_dispatch = server.batcher.batches == 1
        for i, (status, body) in enumerate(results):
            assert status == 200
            [p] = body["predictions"]
            assert p["id"] == f"r{i}"
            if one_dispatch:  # the whole window as one chunk, to the bit
                assert p["prob_fake"] == window[i]["prob_fake"]
            # whatever the windows, the row the caller would have got alone
            assert abs(p["prob_fake"] - direct[i]["prob_fake"]) < 1e-5
        assert server.batcher.batches < len(recs)
    finally:
        _stop(server, thread)


def test_batching_disabled_still_serves(live_server):
    server, thread, url = _serve(live_server["predictor"], batch_window_ms=None)
    try:
        assert server.batcher is None
        status, body = _post(f"{url}/predict", {"records": RECORDS[:1]})
        assert status == 200 and len(body["predictions"]) == 1
    finally:
        _stop(server, thread)


def test_serve_cli_loads_no_jax(exported, tmp_path):
    """`python -m ultrafnd_git_tpu_torch.serve` in a fresh process on the CPU:
    its server answers /healthz, /predict and /explain from its own threads,
    then the process lists the modules of jax and the JAX package it loaded."""
    code = f"""
import contextlib, io, json, re, sys, threading, time, urllib.request
from ultrafnd_git_tpu_torch import serve
out = io.StringIO()
with contextlib.redirect_stdout(out):
    threading.Thread(target=serve.main, daemon=True, args=([
        "--model_dir", {exported!r}, "--device", "cpu", "--port", "0", "--warmup", "8"],)).start()
    for _ in range(600):
        m = re.search(r"on (http://[\\d.]+:\\d+)", out.getvalue())
        if m:
            break
        time.sleep(0.1)
url = m.group(1)
def post(path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={{"Content-Type": "application/json"}})
    return json.loads(urllib.request.urlopen(req, timeout=120).read())
health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=30).read())
rows = post("/predict", {{"records": [{{"title": "外星人 警告"}}, {{"title": "辟谣"}}]}})
expl = post("/explain", {{"records": [{{"title": "外星人 警告"}}], "top_k": 2}})
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("ultrafnd_git_tpu", "jax", "jaxlib", "flax", "optax", "orbax"))
print(json.dumps({{"health": health, "n": len(rows["predictions"]),
                  "method": expl["predictions"][0]["explain"]["method"], "bad": bad,
                  "warmup": "warmup: 1 bucket sizes" in out.getvalue()}}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["warmup"]
    assert res["health"]["status"] == "ok" and res["health"]["backend"] == "cpu"
    assert res["n"] == 2 and res["method"] == "grad_x_input"


def test_serve_cli_cuda_default_raises_without_a_gpu(exported, monkeypatch):
    from ultrafnd_git_tpu_torch.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model_dir", exported, "--port", "0"])
