"""PyTorch port, the v1 ensemble (`training/pipeline_v1.py`) against the
JAX package's, on the CPU. (Its feature stage and CLI:
tests/test_torch_v1_features.py.)

* `focal_loss` / CE within 1e-6 of optax's; `mixup_arrays` the same draws.
* The JAX ensemble's initial params carried across
  (`utils/transfer.ensemble_state_dicts_from_params`): eval probabilities
  within 1e-4; with dropout off, one step's loss within 1e-5 and each
  member's gradient leaves within 1e-4 of the leaf's largest value plus
  1e-9. The 1e-9: attn_vu's evidence-gate bias gets a gradient of at most
  2.5e-6 here, the difference of near-equal terms, and against a float64
  run of the JAX step JAX's own f32 gradient of it is 1.0e-4 of its
  largest value off (the port's 6.4e-5), so two f32 orders of the same sum
  are 1.7e-4 apart there: 4e-10 absolute;
* one clipped step (the clip binding, K1's plain version) from the same
  gradients gives params within 1e-6 of optax's.
* `train_and_evaluate` in dummy mode returns JAX's keys and step count.
* No CPU fallback: a failing step or CV stage raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ultrafnd_git_tpu.training import pipeline_v1 as jax_v1
from ultrafnd_git_tpu_torch.training import pipeline_v1 as port_v1
from ultrafnd_git_tpu_torch.utils.transfer import ensemble_state_dicts_from_params

PROB_ATOL = 1e-4
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-9
PARAM_ATOL = 1e-6
BATCH = 4


def test_loss_and_mixup_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 2)).astype(np.float32) * 3
    y = rng.integers(0, 2, 16)
    ref_ce = np.asarray(optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits),
                                                                        jnp.asarray(y)))
    got_ce = port_v1.cross_entropy(torch.from_numpy(logits), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got_ce, ref_ce, atol=1e-6, rtol=0)
    for alpha, gamma in ((1.0, 2.0), (0.5, 1.5)):
        ref = np.asarray(jax_v1.focal_loss(jnp.asarray(logits), jnp.asarray(y), alpha, gamma))
        got = port_v1.focal_loss(torch.from_numpy(logits), torch.from_numpy(y), alpha,
                                 gamma).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    jr, pr = np.random.default_rng(3), np.random.default_rng(3)
    for alpha in (0.2, 0.0, 0.4):
        (jl, jp), (pl, pp) = jax_v1.mixup_arrays(jr, 8, alpha), port_v1.mixup_arrays(pr, 8, alpha)
        assert jl == pl and np.array_equal(jp, pp) and pp.dtype == np.int32


@pytest.fixture(scope="module")
def ensembles():
    """(JAX trainer, port trainer with the JAX initial params, a feature
    batch, labels)."""
    cfg = dict(batch_size=BATCH, ensemble_size=2, epochs=1)
    # the JAX trainer draws its members by an eager jax.vmap of the modules'
    # init, slow op by op on a CPU; compiled, the same draw is a few times
    # faster
    vmap = jax.vmap
    jax.vmap = lambda f, *a, **kw: jax.jit(vmap(f, *a, **kw))
    try:
        jt = jax_v1.EnsembleTrainer(jax_v1.V1Config(**cfg))
    finally:
        jax.vmap = vmap
    pt = port_v1.EnsembleTrainer(port_v1.V1Config(**cfg), device="cpu")
    pt.load_state_dicts(ensemble_state_dicts_from_params(jax.device_get(jt.params)))
    feats, _ = port_v1._dummy_feature_batches(BATCH, BATCH, seed=5)[0]
    return jt, pt, feats, np.array([0, 1, 1, 0], np.int64)


def _jax_member_grads(jt, feats, labels, lam, perm):
    """JAX's per-member (loss, grads) of one batch with dropout off: the
    step's member loss with rng None, vmapped over the members."""
    f = {k: jnp.asarray(feats[k]) for k in ("text", "audio", "visual", "temporal")}
    aux, ev = jnp.asarray(feats["aux"]), jnp.asarray(feats["evidence"])
    y, perm = jnp.asarray(labels, jnp.int32), jnp.asarray(perm)

    def loss(mp):
        mixed = {k: lam * v + (1.0 - lam) * v[perm] for k, v in f.items()}
        logits = jt._member_logits(mp, mixed, lam * aux + (1.0 - lam) * aux[perm],
                                   lam * ev + (1.0 - lam) * ev[perm], None)
        la, lb = jax_v1.focal_loss(logits, y), jax_v1.focal_loss(logits, y[perm])
        return (lam * la + (1.0 - lam) * lb).mean()

    return jax.jit(jax.vmap(jax.value_and_grad(loss)))(jt.params)


def _torch_tree(pairs):
    return [{"fusion": {k: torch.from_numpy(v) for k, v in f.items()},
             "clf": {k: torch.from_numpy(v) for k, v in c.items()}} for f, c in pairs]


def test_eval_probs_and_step_match_jax(ensembles):
    jt, pt, feats, labels = ensembles
    ref = jt.predict_batch(feats)
    np.testing.assert_allclose(pt.predict_batch(feats), ref, atol=PROB_ATOL, rtol=0)

    lam, perm = port_v1.mixup_arrays(np.random.default_rng(1), BATCH, 0.2)
    j_loss, j_grads = _jax_member_grads(jt, feats, labels, lam, perm)
    p_loss, p_grads = pt.grads_of(feats, labels, lam, perm, gen=None)
    np.testing.assert_allclose(p_loss.numpy(), np.asarray(j_loss), atol=1e-5, rtol=0)
    ref_grads = _torch_tree(ensemble_state_dicts_from_params(jax.device_get(j_grads)))
    for e, (pg, jg) in enumerate(zip(p_grads, ref_grads)):
        assert pg["fusion"].keys() <= jg["fusion"].keys() and len(pg["clf"]) == 61
        for part in ("fusion", "clf"):
            for name, g in pg[part].items():
                r = jg[part][name].numpy()
                gap = float(np.abs(g.numpy() - r).max())
                bound = GRAD_REL * float(np.abs(r).max()) + GRAD_FLOOR
                assert gap <= bound, f"member {e} {part}.{name}: {gap} > {bound}"

    # one clipped step from JAX's gradients: the clip, then optax.adamw /
    # K1's plain version; the clip binds for both members
    clip = 0.5 * min(float(optax.global_norm(jax.tree.map(lambda x: x[e], j_grads)))
                     for e in range(2))
    pt.cfg.grad_clip = clip

    @jax.jit
    def jax_step(grads, opt_state, params):
        def clip_member(g):
            scale = jnp.minimum(1.0, clip / (optax.global_norm(g) + 1e-9))
            return jax.tree.map(lambda x: x * scale, g)

        updates, _ = jt.tx.update(jax.vmap(clip_member)(grads), opt_state, params)
        return optax.apply_updates(params, updates)

    new = ensemble_state_dicts_from_params(jax.device_get(jax_step(j_grads, jt.opt_state,
                                                                    jt.params)))
    pt.apply_grads(ref_grads)
    assert pt.step_count == 1 and pt.opt_state["count"] == 1
    for m, (fsd, csd) in zip(pt.members, new):
        for part, sd in (("fusion", fsd), ("clf", csd)):
            for name, p in m[part].named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), sd[name], atol=PARAM_ATOL,
                                           rtol=0, err_msg=f"{part}.{name}")


def test_dummy_run_returns_jax_keys(ensembles, monkeypatch):
    """Both packages' dummy runs (the JAX run on the fixture's trainer, whose
    construction is the slow part there)."""
    jt = ensembles[0]
    monkeypatch.setattr(jax_v1, "EnsembleTrainer", lambda cfg: jt)
    cfg = dict(epochs=1, batch_size=BATCH, ensemble_size=2, debug_mode=True, dummy_samples=12,
               eval_every=1)
    ref = jax_v1.train_and_evaluate(cfg=jax_v1.V1Config(**cfg))
    got = port_v1.train_and_evaluate(cfg=port_v1.V1Config(**cfg), device="cpu")
    assert list(got) == list(ref)
    assert got["steps"] == ref["steps"] == 2 and got["ensemble_size"] == 2
    assert np.isfinite(got["loss"]) and 0.0 <= got["val_acc"] <= 1.0


def test_failing_step_or_stage_raises(ensembles, monkeypatch):
    _, pt, feats, labels = ensembles
    before = pt.step_count

    def broken(*args, **kw):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(pt.tx, "apply", broken)
    with pytest.raises(RuntimeError, match="injected"):
        pt.train_batch(feats, labels, np.random.default_rng(0))
    assert pt.step_count == before and pt.device.type == "cpu"

    rng = np.random.default_rng(0)
    batch = {
        "text_data": [{"title": "a b", "ocr": "c", "comments": ["d"]}] * 2,
        "audio_waveform": rng.standard_normal((2, 8000)).astype(np.float32),
        "video_frames": rng.integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8),
    }
    monkeypatch.setenv("ULTRAFND_DEVICE_CV", "1")
    ext = port_v1.BatchFeatureExtractor(seed=0, device="cpu")
    assert ext(batch)["visual"].shape == (2, 512)
    monkeypatch.setattr(ext._device_cv, "finalize", broken)
    with pytest.raises(RuntimeError, match="injected"):
        ext(batch)
    assert ext._device_cv is not None  # still the stage: no host-ladder fallback
    monkeypatch.setattr(ext._device_cv, "dispatch", broken)
    with pytest.raises(RuntimeError, match="injected"):
        next(ext.stream([(batch, 0)]))
