"""PyTorch port, the tensor-parallel fusion and classifier at tp = 2 (two
gloo ranks, `tests/_torch_mesh_worker.py`), on weights made by the JAX
modules and carried across (`utils/transfer.py`): each rank's outputs
equal JAX's within 1e-4 (PARITY.md §2.5) and the port's unsharded modules'
within 1e-5; each shard's gradient is the slice of the unsharded gradient
within 1e-5 (a replicated leaf's is the whole); the global norm over the
shards is the unsharded norm within 1e-6 relative (K1's clip,
`kernels/adamw.global_norm`); one clipped plain AdamW step on the shards,
from the slices of the unsharded gradients, is the slice of the unsharded
step within 1e-6 (from each rank's own gradients, an element whose
gradient is rounding noise could take Adam's step of the other sign)."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import launch
from ultrafnd_git_tpu.models.classifier import DeepTruthClassifier as JaxClassifier
from ultrafnd_git_tpu.models.fusion import CrossModalTransformer as JaxFusion
from ultrafnd_git_tpu.utils.torch_transfer import classifier_state_dict_from_params
from ultrafnd_git_tpu_torch.kernels.adamw import AdamW, global_norm
from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier
from ultrafnd_git_tpu_torch.models.fusion import CrossModalTransformer
from ultrafnd_git_tpu_torch.parallel.mesh import split_dim
from ultrafnd_git_tpu_torch.utils.transfer import fusion_state_dict

B, TP, CLIP = 8, 2, 0.05  # CLIP: well under the gradient's norm, so the step clips
FUSION = dict(hidden=64, use_gnn=True, gnn_dim=16)
CLF = dict(in_dim=64, hidden=32, node_trees=3, node_depth=3)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(JAX outputs, the port's unsharded outputs / gradients / norm / step,
    each rank's results)."""
    rng = np.random.default_rng(11)
    feats = {"text_features": rng.standard_normal((B, 768)),
             "audio_features": rng.standard_normal((B, 128)),
             "visual_features": rng.standard_normal((B, 512)),
             "temporal_features": rng.standard_normal((B, 256)),
             "gnn_feat": rng.standard_normal((B, 16))}
    feats = {k: v.astype(np.float32) for k, v in feats.items()}
    aux = rng.uniform(size=(B, 2)).astype(np.float32)
    probe = rng.standard_normal((B, 2)).astype(np.float32)
    jf = JaxFusion(hidden=64, use_gnn=True, gnn_dim=16)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    fparams = jax.device_get(jf.init(KEY, jfeats)["params"])
    jfo = jf.apply({"params": fparams}, jfeats, deterministic=True)
    jc = JaxClassifier(hidden=32, node_trees=3, node_depth=3)
    cparams = dict(jax.device_get(jc.init(KEY, jfo["fused"], jnp.asarray(aux))["params"]))
    cparams["node"] = {"gates": rng.standard_normal((3, 3, 32)).astype(np.float32),
                       "thresh": 0.1 * rng.standard_normal((3, 3)).astype(np.float32),
                       "leaf_logits": rng.standard_normal((3, 8, 2)).astype(np.float32)}
    jco = jc.apply({"params": cparams}, jfo["fused"], jnp.asarray(aux), deterministic=True)
    weights = {"fusion": fusion_state_dict(fparams),
               "clf": classifier_state_dict_from_params(cparams, tau=10.0)}
    weights = {p: {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}
               for p, sd in weights.items()}
    data = {"weights": weights, "feats": {k: torch.from_numpy(v) for k, v in feats.items()},
            "aux": torch.from_numpy(aux), "probe": torch.from_numpy(probe)}
    root = tmp_path_factory.mktemp("tp")

    mods = {"fusion": CrossModalTransformer(**FUSION), "clf": DeepTruthClassifier(**CLF)}
    for part, mod in mods.items():
        mod.load_state_dict(weights[part])
    fo = mods["fusion"](data["feats"])
    co = mods["clf"](fo["fused"], data["aux"])
    ((co["logits"] * data["probe"]).sum() + (fo["logits"] * data["probe"]).sum()).backward()
    grads = {p: {n: torch.zeros_like(q) if q.grad is None else q.grad.clone()
                 for n, q in m.named_parameters()} for p, m in mods.items()}
    norm = global_norm([g for d in grads.values() for g in d.values()])
    opt = AdamW(lambda count: 1e-3, weight_decay=1e-4, grad_clip=CLIP)
    state = opt.init(mods)
    with torch.no_grad():
        opt.apply(mods, state, grads)
    assert float(norm) > 4 * CLIP
    data["grads"] = grads
    torch.save(data, root / "inputs.pt")
    full = {"fused": fo["fused"].detach(), "fusion_logits": fo["logits"].detach(),
            "clf_logits": co["logits"].detach(), "probs": co["probs"].detach(),
            "grads": grads, "norm": norm,
            "stepped": {p: {k: v.clone() for k, v in m.state_dict().items()}
                        for p, m in mods.items()}}
    jax_out = {"fused": np.asarray(jfo["fused"]), "fusion_logits": np.asarray(jfo["logits"]),
               "clf_logits": np.asarray(jco["logits"]), "probs": np.asarray(jco["probs"])}
    case = {"kind": "modules", "name": "tp", "inputs": str(root / "inputs.pt"), "tp": TP,
            "fusion": FUSION, "clf": CLF, "clip": CLIP}
    ranks = [r["tp"] for r in launch([case], TP, root / "out")]
    yield jax_out, full, ranks
    shutil.rmtree(root, ignore_errors=True)


def _slice(t, part, name, rank):
    dim = split_dim(part, name)
    if dim is None:
        return t
    per = t.shape[dim] // TP
    return t.narrow(dim, rank * per, per)


def test_sharded_outputs_match_jax_and_the_unsharded_modules(run):
    jax_out, full, ranks = run
    for res in ranks:
        assert res["coords"]["model"] in (0, 1) and not res["modules"]
        for key in ("fused", "fusion_logits", "clf_logits", "probs"):
            np.testing.assert_allclose(res[key].numpy(), jax_out[key], atol=1e-4, err_msg=key)
            np.testing.assert_allclose(res[key].numpy(), full[key].numpy(), atol=1e-5,
                                       err_msg=key)


def test_each_shard_gradient_is_the_slice_of_the_unsharded(run):
    _, full, ranks = run
    n_split = 0
    for res in ranks:
        rank = res["coords"]["model"]
        for part, leaves in full["grads"].items():
            for name, g in leaves.items():
                ours = res["grads"][part][name]
                ref = _slice(g, part, name, rank)
                assert ours.shape == ref.shape, name
                np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5,
                                           err_msg=f"{part}.{name}")
                n_split += split_dim(part, name) is not None
    assert n_split == 6 * TP  # fuse_mlp.0 weight and bias, .3 weight; pre likewise


def test_global_norm_over_the_shards_is_the_unsharded_norm(run):
    _, full, ranks = run
    for res in ranks:
        assert abs(float(res["norm"]) / float(full["norm"]) - 1.0) < 1e-6


def test_clipped_adamw_step_on_the_shards_is_the_slice_of_the_unsharded_step(run):
    _, full, ranks = run
    for res in ranks:
        rank = res["coords"]["model"]
        for part, sd in full["stepped"].items():
            for name, t in sd.items():
                np.testing.assert_allclose(res["stepped"][part][name].numpy(),
                                           _slice(t, part, name, rank).numpy(),
                                           atol=1e-6, rtol=0, err_msg=f"{part}.{name}")
