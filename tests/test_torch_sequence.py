"""PyTorch port, sequence parallelism: `kernels/ring_attention.py` and
`parallel/sequence.py` against the JAX package's (`tests/test_sequence.py`),
on ranks of one gloo world of 4 (processes of `tests/_torch_mesh_worker.py`,
meshes (data, model, sp) over it):

* the ring at n = 2 and 4 against `ring_attention_local` under shard_map
  on the conftest's virtual CPU devices, atol 2e-6, rtol 1e-5 (JAX's own
  bound), with a row whose first key block is all padding and a row that
  is all padding; its gradients on q, k and v (through the ppermute's
  backward) against autograd of one-shot attention;
* the sp tower at {dp=2, sp=2} and {sp=4} against
  `sequence_parallel_tower_apply` (atol 2e-5, rtol 1e-4) and against the
  plain port tower, and at {dp=2, sp=2} in bf16 within 2e-2;
* training mode: an sp tower step draws the plain port tower's dropout
  masks (the pooled rows and every gradient, summed over sp and data as
  the trainer sums them, within 1e-5 of the plain step's; the generator
  ends where the plain one does);
* JAX's error for a length sp does not divide;
* the mesh's extra axis: the world's ranks hold the (data, model, sp)
  coordinates of the devices at their index in JAX's mesh, and the shapes
  and the dp inference over tp * extra are JAX's, its error text too.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from _torch_mesh_worker import collect, start
from ultrafnd_git_tpu.models.transformer import TextTransformer as JaxTextTransformer
from ultrafnd_git_tpu.parallel import mesh as jmesh
from ultrafnd_git_tpu.parallel.sequence import (
    _ring_attention_local,
    sequence_parallel_tower_apply as jax_sp_apply,
)
from ultrafnd_git_tpu_torch.models.transformer import TextTransformer
from ultrafnd_git_tpu_torch.parallel import mesh as meshlib
from ultrafnd_git_tpu_torch.parallel.collectives import Shard
from ultrafnd_git_tpu_torch.parallel.sequence import sequence_parallel_tower_apply
from ultrafnd_git_tpu_torch.utils.transfer import tower_state_dict

WIDTH, HEADS, DEPTH, L, B, VOCAB = 32, 4, 2, 16, 4, 128
TOWER = dict(width=WIDTH, depth=DEPTH, heads=HEADS, vocab_size=VOCAB, max_len=L)
RING = dict(atol=2e-6, rtol=1e-5)  # JAX's ring bound (tests/test_sequence.py)
SP_TOWER = dict(atol=2e-5, rtol=1e-4)  # JAX's sp tower bound
BF16 = 2e-2
TOWER_CASES = {  # name -> (dp, sp, bf16, dropout seed)
    "dp2_sp2": (2, 2, False, None),
    "sp4": (1, 4, False, None),
    "dp2_sp2_bf16": (2, 2, True, None),
    "dp2_sp2_train": (2, 2, False, 5),
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


def _ring_inputs():
    rng = np.random.default_rng(1)
    q, k, v, probe = (rng.standard_normal((B, HEADS, L, 8)).astype(np.float32)
                      for _ in range(4))
    mask = np.ones((B, L), np.float32)
    mask[1, : L // 2] = 0.0  # the first key block all padding (the first two at n = 4)
    mask[2] = 0.0  # all padding
    mask[3, 11:] = 0.0
    bias = ((1.0 - mask) * -1e9)[:, None, None, :].astype(np.float32)
    return q, k, v, bias, probe


def _tower_inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, VOCAB, size=(B, L)).astype(np.int32)
    lens = np.array([L, L - 5, 3, 0])  # a row padded past a whole shard, and an empty one
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    ids = ids * mask.astype(np.int32)
    probe = rng.standard_normal((B, WIDTH)).astype(np.float32)
    return ids, mask, probe


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's results {case: [rank results]}, the JAX references and
    the tower's weights."""
    root = tmp_path_factory.mktemp("sequence")
    jt = JaxTextTransformer(**TOWER)
    ids, mask, probe = _tower_inputs()
    params = jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))[
        "params"]
    weights = {k: torch.from_numpy(np.asarray(v)) for k, v in
               tower_state_dict(jax.device_get(params)).items()}
    torch.save({"weights": weights, "ids": torch.from_numpy(ids).long(),
                "mask": torch.from_numpy(mask), "probe": torch.from_numpy(probe)},
               root / "tower.pt")
    q, k, v, bias, rprobe = _ring_inputs()
    torch.save({n: torch.from_numpy(a) for n, a in
                (("q", q), ("k", k), ("v", v), ("bias", bias), ("probe", rprobe))},
               root / "ring.pt")
    cases = [{"kind": "ring", "name": f"ring{n}", "n": n, "inputs": str(root / "ring.pt")}
             for n in (2, 4)]
    cases += [{"kind": "tower", "name": name, "axis": "sp", "n": sp, "dp": dp, "bf16": bf16,
               "seed": seed, "tower": TOWER, "inputs": str(root / "tower.pt")}
              for name, (dp, sp, bf16, seed) in TOWER_CASES.items()]
    started = start(cases, 4, root / "w4")

    jax_ring = {}  # jitted: eager shard_map dispatches op by op
    for n in (2, 4):
        ring = shard_map(
            lambda q, k, v, b: _ring_attention_local(q, k, v, b, "sp"),
            mesh=Mesh(np.array(jax.devices("cpu")[:n]), ("sp",)),
            in_specs=(P(None, None, "sp", None),) * 3 + (P(None, None, None, "sp"),),
            out_specs=P(None, None, "sp", None))
        jax_ring[n] = np.asarray(jax.jit(ring)(q, k, v, bias))
    jax_tower = {}
    for name, (dp, sp, bf16, seed) in TOWER_CASES.items():
        if seed is not None:
            continue
        mesh = jmesh.make_mesh(dp=dp, tp=1, devices=jax.devices("cpu"),
                               extra_axes=(("sp", sp),))
        tower = JaxTextTransformer(**TOWER, dtype=jnp.bfloat16 if bf16 else None)
        apply = jax.jit(lambda p, i, m, tower=tower, mesh=mesh: jax_sp_apply(
            tower, p, i, m, mesh, batch_axis="data"))
        jax_tower[name] = np.asarray(apply(params, jnp.asarray(ids), jnp.asarray(mask)),
                                     np.float32)
    ranks = collect(started)
    yield ({c["name"]: [r[c["name"]] for r in ranks] for c in cases}, jax_ring, jax_tower,
           weights)
    shutil.rmtree(root, ignore_errors=True)


def _rows(res, n_rows):
    """The global batch's rows from each data rank's (its first rank on the
    other axes)."""
    by_data = {}
    for r in res:
        by_data.setdefault(r["coords"]["data"], r["out"])
    return torch.cat([by_data[d] for d in sorted(by_data)]).numpy()[:n_rows]


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax(runs, n):
    res, jax_ring, _, _ = runs
    ranks = [r for r in res[f"ring{n}"] if r["coords"]["data"] == 0]
    got = torch.cat([r["out"] for r in sorted(ranks, key=lambda r: r["coords"]["sp"])], dim=2)
    np.testing.assert_allclose(got.numpy(), jax_ring[n], **RING)
    assert not any(r["modules"] for r in res[f"ring{n}"])  # the ranks load no jax


@pytest.mark.parametrize("n", [2, 4])
def test_ring_gradients_match_one_shot_attention(runs, n):
    res, _, _, _ = runs
    q, k, v, bias, probe = (torch.from_numpy(a).requires_grad_(i < 3)
                            for i, a in enumerate(_ring_inputs()))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1]) + bias
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
    (out * probe).sum().backward()
    ranks = sorted((r for r in res[f"ring{n}"] if r["coords"]["data"] == 0),
                   key=lambda r: r["coords"]["sp"])
    for name, ref in (("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        got = torch.cat([r[name] for r in ranks], dim=2)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["dp2_sp2", "sp4"])
def test_sp_tower_matches_jax_and_the_plain_tower(runs, name):
    res, _, jax_tower, weights = runs
    got = _rows(res[name], B)
    np.testing.assert_allclose(got, jax_tower[name], **SP_TOWER)
    tower = TextTransformer(**TOWER)
    tower.load_state_dict(weights)
    ids, mask, _ = _tower_inputs()
    with torch.no_grad():
        plain = tower(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, plain, **SP_TOWER)
    for r in res[name]:  # every rank of an sp group holds the same rows
        same = [o for o in res[name] if o["coords"]["data"] == r["coords"]["data"]]
        assert torch.equal(r["out"], same[0]["out"])


def test_sp_tower_bf16_matches_jax(runs):
    res, _, jax_tower, _ = runs
    np.testing.assert_allclose(_rows(res["dp2_sp2_bf16"], B), jax_tower["dp2_sp2_bf16"],
                               atol=BF16, rtol=0)


def test_sp_training_draws_the_plain_towers_masks(runs):
    res, _, _, weights = runs
    tower = TextTransformer(**TOWER)
    tower.load_state_dict(weights)
    ids, mask, probe = _tower_inputs()
    gen = torch.Generator().manual_seed(TOWER_CASES["dp2_sp2_train"][3])
    out = tower(torch.from_numpy(ids).long(), torch.from_numpy(mask), gen)
    (out * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(_rows(res["dp2_sp2_train"], B), out.detach().numpy(),
                               atol=1e-5, rtol=0)
    for r in res["dp2_sp2_train"]:
        assert torch.equal(r["gen_state"], gen.get_state())
        for key, p in tower.named_parameters():
            np.testing.assert_allclose(r["grads"][key].numpy(), p.grad.numpy(), atol=1e-5,
                                       rtol=0, err_msg=key)
        # the forward: one packed hop a block, one pooling sum; the step adds
        # the hops' backward and the two gradient sums
        assert r["calls"] == (DEPTH + 1, 2 * DEPTH + 1 + 2)


def test_sp_rejects_a_length_it_does_not_divide():
    tower = TextTransformer(**TOWER)
    ids, mask, _ = _tower_inputs()
    with pytest.raises(ValueError, match=f"seq len {L - 3} not divisible by sp=4"):
        sequence_parallel_tower_apply(tower, torch.from_numpy(ids[:, : L - 3]).long(),
                                      torch.from_numpy(mask[:, : L - 3]), Shard(None, 0, 4))
    jt = JaxTextTransformer(**TOWER)
    params = jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))[
        "params"]
    with pytest.raises(ValueError, match=f"seq len {L - 3} not divisible by sp=4"):
        jax_sp_apply(jt, params, jnp.asarray(ids[:, : L - 3]), jnp.asarray(mask[:, : L - 3]),
                     Mesh(np.array(jax.devices("cpu")[:4]), ("sp",)))


def test_extra_axes_lay_the_ranks_out_as_jax(runs):
    res = runs[0]["dp2_sp2"]  # in rank order
    jm = jmesh.make_mesh(dp=2, tp=1, devices=jax.devices("cpu"), extra_axes=(("sp", 2),))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank, r in enumerate(res):
        position = np.argwhere(ids == rank)[0]
        assert r["coords"] == {a: int(i) for a, i in zip(jm.axis_names, position)}
    for kw in (dict(extra_axes=(("sp", 2),)), dict(tp=2, extra_axes=(("pipe", 2),)),
               dict(dp=2, extra_axes=(("sp", 4),))):
        want = dict(jmesh.make_mesh(devices=jax.devices("cpu"), **kw).shape)
        assert meshlib.mesh_shape(8, **kw) == want, kw
    for make in (lambda: jmesh.make_mesh(tp=2, devices=jax.devices("cpu"),
                                         extra_axes=(("pipe", 3),)),
                 lambda: meshlib.mesh_shape(8, tp=2, extra_axes=(("pipe", 3),))):
        with pytest.raises(ValueError, match="8 devices not divisible by tp\\*extra\\*dcn=6"):
            make()
