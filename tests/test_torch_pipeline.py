"""PyTorch port, pipeline parallelism: `parallel/pipeline.py` against the
JAX package's (`tests/test_pipeline.py`), on ranks of one gloo world of 4
(processes of `tests/_torch_mesh_worker.py`, meshes (data, model, pipe)
over it):

* the pipelined tower at (S, M) = (2, 2) and (2, 4) under dp = 2 and at
  (4, 4) against `pipelined_tower_apply` on the conftest's virtual CPU
  devices and against the plain port tower, atol 2e-6;
* training mode: a pipelined step at (2, 4) under dp = 2 draws the plain
  port tower's dropout masks (the pooled rows and every gradient, summed
  over pipe and data as the trainer sums them, within 2e-6 of the plain
  step's; the generator ends where the plain one does), with T - 1 hops
  each way and one closing sum;
* each stage runs its blocks on its M microbatches only, not on the
  fill and drain ticks;
* JAX's divisibility errors, with its text, in both packages.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import collect, start
from ultrafnd_git_tpu.models.transformer import TextTransformer as JaxTextTransformer
from ultrafnd_git_tpu.parallel import mesh as jmesh
from ultrafnd_git_tpu.parallel.pipeline import pipelined_tower_apply as jax_pp_apply
from ultrafnd_git_tpu_torch.models.transformer import TextTransformer
from ultrafnd_git_tpu_torch.parallel.collectives import Shard
from ultrafnd_git_tpu_torch.parallel.pipeline import pipeline_blocks
from ultrafnd_git_tpu_torch.utils.transfer import tower_state_dict

WIDTH, HEADS, DEPTH, L, B, VOCAB = 32, 4, 4, 8, 8, 128
TOWER = dict(width=WIDTH, depth=DEPTH, heads=HEADS, vocab_size=VOCAB, max_len=L)
ATOL = 2e-6
CASES = {  # name -> (dp, S, M, dropout seed)
    "dp2_s2_m2": (2, 2, 2, None),
    "dp2_s2_m4": (2, 2, 4, None),
    "s4_m4": (1, 4, 4, None),
    "dp2_s2_m4_train": (2, 2, 4, 7),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side of these tests runs small tensors, which one thread
    computes faster than a pool that parallel test workers oversubscribe;
    the previous count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, VOCAB, size=(B, L)).astype(np.int32)
    lens = np.array([L, 5, 1, 0, 3, L, 2, 7])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    ids = ids * mask.astype(np.int32)
    probe = rng.standard_normal((B, WIDTH)).astype(np.float32)
    return ids, mask, probe


def _params():
    ids, mask, _ = _inputs()
    return jax.jit(JaxTextTransformer(**TOWER).init)(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: [rank results]}, the JAX references and the tower's weights."""
    root = tmp_path_factory.mktemp("pipeline")
    ids, mask, probe = _inputs()
    params = _params()
    weights = {k: torch.from_numpy(np.asarray(v)) for k, v in
               tower_state_dict(jax.device_get(params)).items()}
    torch.save({"weights": weights, "ids": torch.from_numpy(ids).long(),
                "mask": torch.from_numpy(mask), "probe": torch.from_numpy(probe)},
               root / "tower.pt")
    cases = [{"kind": "tower", "name": name, "axis": "pipe", "n": s, "dp": dp,
              "microbatches": m, "seed": seed, "tower": TOWER, "inputs": str(root / "tower.pt")}
             for name, (dp, s, m, seed) in CASES.items()]
    started = start(cases, 4, root / "w4")
    jax_out = {}
    tower = JaxTextTransformer(**TOWER)
    for name, (dp, s, m, seed) in CASES.items():
        if seed is not None:
            continue
        mesh = jmesh.make_mesh(dp=dp, tp=1, devices=jax.devices("cpu"),
                               extra_axes=(("pipe", s),))
        apply = jax.jit(lambda p, i, k, mesh=mesh, m=m: jax_pp_apply(
            tower, p, i, k, mesh, microbatches=m, batch_axis="data"))
        jax_out[name] = np.asarray(apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    ranks = collect(started)
    yield {c["name"]: [r[c["name"]] for r in ranks] for c in cases}, jax_out, weights
    shutil.rmtree(root, ignore_errors=True)


def _rows(res):
    """The global batch's rows from each data rank's."""
    by_data = {}
    for r in res:
        by_data.setdefault(r["coords"]["data"], r["out"])
    return torch.cat([by_data[d] for d in sorted(by_data)]).numpy()


def _plain(weights, seed=None):
    tower = TextTransformer(**TOWER)
    tower.load_state_dict(weights)
    ids, mask, probe = _inputs()
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    out = tower(torch.from_numpy(ids).long(), torch.from_numpy(mask), gen)
    (out * torch.from_numpy(probe)).sum().backward()
    return tower, out.detach().numpy(), gen


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[3] is None])
def test_pipelined_tower_matches_jax_and_the_plain_tower(runs, name):
    res, jax_out, weights = runs
    got = _rows(res[name])
    np.testing.assert_allclose(got, jax_out[name], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _plain(weights)[1], atol=ATOL, rtol=0)
    for r in res[name]:
        assert not r["modules"]  # the ranks load no jax
        same = [o for o in res[name] if o["coords"]["data"] == r["coords"]["data"]]
        assert torch.equal(r["out"], same[0]["out"])  # every stage holds the rows


def test_pipelined_training_draws_the_plain_towers_masks(runs):
    res, _, weights = runs
    dp, s, m, seed = CASES["dp2_s2_m4_train"]
    tower, out, gen = _plain(weights, seed)
    np.testing.assert_allclose(_rows(res["dp2_s2_m4_train"]), out, atol=ATOL, rtol=0)
    ticks = m + s - 1
    for r in res["dp2_s2_m4_train"]:
        assert torch.equal(r["gen_state"], gen.get_state())
        for key, p in tower.named_parameters():
            np.testing.assert_allclose(r["grads"][key].numpy(), p.grad.numpy(), atol=ATOL,
                                       rtol=0, err_msg=key)
        # T - 1 hops and the closing sum; the backward's hops; two gradient sums
        assert r["calls"] == (ticks, 2 * (ticks - 1) + 1 + 2)


@pytest.mark.parametrize("name", list(CASES))
def test_each_stage_runs_its_blocks_once_a_microbatch(runs, name):
    """M x D / S block calls on each rank, none on a fill or drain tick."""
    res, _, _ = runs
    _, s, m, _ = CASES[name]
    for r in res[name]:
        assert r["block_calls"] == m * DEPTH // s


@pytest.mark.parametrize("S,M,dp,text", [
    (3, None, 1, "depth=4 not divisible by stages=3"),
    (2, 3, 1, "batch=8 not divisible by microbatches=3"),
    (4, 2, 1, "microbatches=2 not divisible by stages=4"),
    (2, 8, 2, "microbatch rows 1 not divisible by data=2"),
])
def test_divisibility_errors_are_jaxs(S, M, dp, text):
    """Depth 4 and a batch of 8 rows, 8 / dp on each data rank."""
    ids, mask, _ = _inputs()
    tower = TextTransformer(**TOWER)
    data = Shard(None, 0, dp) if dp > 1 else None
    with pytest.raises(ValueError, match=text):
        pipeline_blocks(list(tower.blocks), torch.zeros(B // dp, L, WIDTH),
                        torch.ones(B // dp, L), Shard(None, 0, S), M, data)
    mesh = jmesh.make_mesh(dp=dp, tp=1, devices=jax.devices("cpu"), extra_axes=(("pipe", S),))
    with pytest.raises(ValueError, match=text):
        jax_pp_apply(JaxTextTransformer(**TOWER), _params(), jnp.asarray(ids),
                     jnp.asarray(mask), mesh, microbatches=M,
                     batch_axis="data" if dp > 1 else None)
