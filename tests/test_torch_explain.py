"""PyTorch port, attributions (`training/interpret.py`, `ops/kernel_shap.py`,
`Predictor.explain`) against the JAX package on the CPU.

The port cannot repeat `jax.random`'s coalition draws, so KernelSHAP is
held by its solver and its axioms, not its samples:
* `feature_importance` (Gradient x Input) matches the JAX one within 1e-5
  abs / 1e-4 rel on the same classifier weights;
* `solve_kernel_shap` on one numpy coalition design matches JAX's within
  1e-5 (relative to the largest value), also with fewer coalitions than
  features (the minimum-norm solution);
* the efficiency axiom |base + sum(phi) - f(x)| <= 1e-5, and the closed
  form w (x - mean(background)) of a linear model (as
  tests/test_kernel_shap.py:30);
* `Predictor.explain(method="grad")` matches the JAX Predictor's explain on
  the exported tower checkpoint within 1e-4 of the largest attribution,
  and its "shap" method returns kernel-shap rows that add up to prob_fake.
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

from ultrafnd_git_tpu.models.classifier import DeepTruthClassifier as JaxClassifier
from ultrafnd_git_tpu.ops.kernel_shap import solve_kernel_shap as jax_solve
from ultrafnd_git_tpu.training import interpret as jax_interpret
from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier
from ultrafnd_git_tpu_torch.ops.kernel_shap import kernel_shap, sample_coalitions, solve_kernel_shap
from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.serving import Predictor
from ultrafnd_git_tpu_torch.training import interpret
from ultrafnd_git_tpu_torch.utils.transfer import classifier_state_dict_from_params

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny" / "data_complete.json"
FUSED, HIDDEN = 24, 32


@pytest.fixture(scope="module")
def classifiers():
    """A JAX classifier with random (non-zero forest) params and the port's
    with the same weights."""
    jm = JaxClassifier(hidden=HIDDEN, node_trees=2, node_depth=2)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, FUSED)), jnp.zeros((2, 2)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.3 * rng.standard_normal(np.shape(p))
                          .astype(np.float32), jax.device_get(params))
    pm = DeepTruthClassifier(in_dim=FUSED, hidden=HIDDEN, node_trees=2, node_depth=2).eval()
    pm.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in
                        classifier_state_dict_from_params(params, tau=10.0).items()})
    return jm, params, pm


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, FUSED)).astype(np.float32),
            rng.uniform(size=(n, 2)).astype(np.float32))


def test_feature_importance_matches_jax(classifiers):
    jm, params, pm = classifiers
    fused, aux = _inputs(9, 1)
    ref, ref_mean = jax_interpret.feature_importance(jm, params, fused, aux)
    with torch.inference_mode():  # the Predictor's context: autograd is switched back on
        ours, mean = interpret.feature_importance(pm, fused, aux)
    assert ours.shape == (9, FUSED + 2)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mean, ref_mean, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("m, f", [(64, 10), (6, 12)], ids=["m_gt_f", "m_lt_f"])
def test_solve_kernel_shap_matches_jax(m, f):
    rng = np.random.default_rng(m + f)
    z = (rng.uniform(size=(m, f)) < 0.5).astype(np.float32)
    y = rng.standard_normal((3, m)).astype(np.float32)
    fx = rng.standard_normal(3).astype(np.float32)
    base = np.float32(0.25)
    ref = np.asarray(jax_solve(*map(jnp.asarray, (y, z, fx, base))))
    ours = solve_kernel_shap(*map(torch.from_numpy, (y, z, fx)), torch.tensor(base)).numpy()
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(base + ours.sum(axis=1), fx, atol=1e-5)


def test_sample_coalitions_follow_the_kernel_and_pair_up():
    z = sample_coalitions(torch.Generator().manual_seed(0), 10, 301)
    again = sample_coalitions(torch.Generator().manual_seed(0), 10, 301)
    assert z.shape == (302, 10) and torch.equal(z, again)
    draws, complements = z[:151], z[151:]
    assert torch.equal(complements, 1.0 - draws)
    sizes = draws.sum(dim=1)
    assert int(sizes.min()) >= 1 and int(sizes.max()) <= 9
    # p(s) ~ 1 / (s (F - s)): the extreme sizes are the most frequent
    counts = torch.bincount(sizes.long(), minlength=10)
    assert counts[1] + counts[9] > counts[4] + counts[5]
    with pytest.raises(ValueError, match=">= 2 features"):
        sample_coalitions(torch.Generator(), 1, 8)


def test_kernel_shap_linear_closed_form():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=12).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(5, 12)).astype(np.float32))
    bg = torch.from_numpy(rng.normal(size=(16, 12)).astype(np.float32))
    phi, base = kernel_shap(lambda xb: xb @ w + 0.7, x, bg, n_coalitions=512, seed=1)
    torch.testing.assert_close(phi, w * (x - bg.mean(dim=0)), atol=2e-4, rtol=0)
    torch.testing.assert_close(base, (bg.mean(dim=0) @ w + 0.7).expand(5), atol=1e-4, rtol=0)


def test_explain_shap_efficiency_axiom_and_fallback(classifiers):
    _, _, pm = classifiers
    fused, aux = _inputs(20, 2)  # two row chunks of 16, the second padded
    bg_f, bg_a = _inputs(8, 3)
    background = np.concatenate([bg_f, bg_a], axis=1)
    out = interpret.explain_shap(pm, fused, aux, n_coalitions=200, background=background)
    assert out["method"] == "kernel-shap" and out["values"].shape == (20, FUSED + 2)
    with torch.no_grad():
        p1 = pm(torch.from_numpy(fused), torch.from_numpy(aux))["probs"][:, 1].numpy()
    assert np.abs(out["base_values"] + out["values"].sum(axis=1) - p1).max() <= 1e-5
    # a background of the wrong width fails KernelSHAP: SmoothGrad's rung, named
    with pytest.warns(UserWarning, match="native KernelSHAP failed"):
        sg = interpret.explain_shap(pm, fused, aux, background=background[:, :5])
    assert sg["method"] == "smooth-grad" and "base_values" not in sg
    assert sg["values"].shape == (20, FUSED + 2) and (sg["values"] >= 0).all()
    np.testing.assert_array_equal(sg["values"], interpret.smooth_grad(pm, fused, aux))


@pytest.fixture(scope="module")
def exported(tower_ckpt, tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("torch_model")
    mod.export(tower_ckpt["out"], str(out))
    yield str(out)
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def predictors(tower_ckpt, exported):
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    pred = Predictor(exported, device="cpu")
    yield JaxPredictor(tower_ckpt["out"]), pred
    pred.close()


def test_predictor_explain_grad_matches_jax(predictors):
    jp, pp = predictors
    records = load_records(FIXTURE)[:12]
    ref = jp.explain(records, method="grad", top_k=512)
    ours = pp.explain(records, method="grad", top_k=512)
    assert [r["id"] for r in ours] == [r["id"] for r in ref]
    for o, r in zip(ours, ref):
        eo, er = o["explain"], r["explain"]
        assert eo["method"] == er["method"] == "grad_x_input" and list(eo) == list(er)
        vo = np.zeros(512)
        vr = np.zeros(512)
        for d, v in eo["top_fused_dims"]:
            vo[d] = v
        for d, v in er["top_fused_dims"]:
            vr[d] = v
        vo = np.concatenate([vo, [eo["aux"]["temporal_delay"], eo["aux"]["emotion"]]])
        vr = np.concatenate([vr, [er["aux"]["temporal_delay"], er["aux"]["emotion"]]])
        assert np.abs(vo - vr).max() <= 1e-4 * np.abs(vr).max()
        assert abs(o["prob_fake"] - r["prob_fake"]) <= 1e-4


def test_predictor_explain_shap_adds_up(predictors):
    jp, pp = predictors
    records = load_records(FIXTURE)[:3]
    np.testing.assert_allclose(pp._explain_background(8), jp._explain_background(8), atol=1e-5)
    rows = pp.explain(records, method="shap", top_k=3, n_coalitions=64, background_size=8)
    for r in rows:
        e = r["explain"]
        assert e["method"] == "kernel-shap" and len(e["top_fused_dims"]) == 3
        total = e["base_value"] + e["fused_signed_sum"] + e["aux"]["temporal_delay"] \
            + e["aux"]["emotion"]
        assert abs(total - r["prob_fake"]) <= 1e-5
    with pytest.raises(ValueError, match="unknown explain method"):
        pp.explain(records, method="lime")
    assert pp.explain([], method="grad") == []


def test_predict_cli_explains(exported, tmp_path):
    from ultrafnd_git_tpu_torch.predict import main

    out = tmp_path / "explained.jsonl"
    main(["--model_dir", exported, "--input", str(FIXTURE), "--output", str(out),
          "--device", "cpu", "--explain", "--explain_method", "grad", "--top_k", "3"])
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(rows) == 64
    assert all(r["explain"]["method"] == "grad_x_input" and len(r["explain"]["top_fused_dims"]) == 3
               for r in rows)
