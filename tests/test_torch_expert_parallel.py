"""PyTorch port, expert parallelism: `models/moe.expert_parallel_` (the
counterpart of JAX's `expert_parallel_specs`, `tests/test_moe.py:98-122`)
on ranks of one gloo world of 4 (processes of
`tests/_torch_mesh_worker.py`; ep = 2 on a (data 2, ep 2) mesh, ep = 4 on
the whole world), 8 experts:

* the output and the aux loss against the whole port module and against
  JAX's `MoEFFN` on the same weights, atol 1e-6, rtol 1e-6 (JAX's own
  bound between its sharded and unsharded module), at capacity factor 2
  and at 0.5, where most tokens are dropped;
* each rank holds E / ep experts, and its expert gradients of
  sum(y * probe) + aux are its slice of the whole module's; the router's
  and the input's gradients are the whole module's.
JAX's ep = 8 case is left out: a world of 8 processes costs too much of
the suite's time.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import collect, start
from ultrafnd_git_tpu.models.moe import MoEFFN as JaxMoEFFN
from ultrafnd_git_tpu_torch.models.moe import EXPERT_LEAVES, MoEFFN, expert_parallel_
from ultrafnd_git_tpu_torch.parallel.collectives import Shard

B, S, W, E, RATIO = 2, 8, 32, 8, 2
TOL = dict(atol=1e-6, rtol=1e-6)
CASES = {"ep2": (2, 2.0), "ep4": (4, 2.0), "ep2_cf0.5": (2, 0.5)}  # name -> (ep, capacity factor)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side of these tests runs small tensors, which one thread
    computes faster than a pool that parallel test workers oversubscribe;
    the previous count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(p):
    sd = {"router.weight": np.asarray(p["router"]["kernel"]).T,
          "router.bias": np.asarray(p["router"]["bias"])}
    sd.update({k: np.asarray(p[k]) for k in EXPERT_LEAVES})
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _whole(weights, cf, x, probe):
    moe = MoEFFN(W, E, RATIO, cf)
    moe.load_state_dict(weights)
    x = torch.from_numpy(x).requires_grad_()
    y, aux = moe(x)
    ((y * torch.from_numpy(probe)).sum() + aux).backward()
    return y.detach(), aux.detach(), x.grad, {k: p.grad for k, p in moe.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: [rank results]}, the JAX outputs and the inputs of each case."""
    root = tmp_path_factory.mktemp("expert_parallel")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    probe = rng.standard_normal((B, S, W)).astype(np.float32)
    cases, jax_out, inputs = [], {}, {}
    for name, (ep, cf) in CASES.items():
        jm = JaxMoEFFN(W, num_experts=E, mlp_ratio=RATIO, capacity_factor=cf)
        params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
        y, aux = jax.jit(lambda p, v, jm=jm: jm.apply({"params": p}, v))(params, jnp.asarray(x))
        jax_out[name] = (np.asarray(y), float(aux))
        inputs[name] = (_state(params), cf)
        torch.save({"weights": inputs[name][0], "x": torch.from_numpy(x),
                    "probe": torch.from_numpy(probe)}, root / f"{name}.pt")
        cases.append({"kind": "ep", "name": name, "n": ep, "inputs": str(root / f"{name}.pt"),
                      "moe": dict(width=W, num_experts=E, mlp_ratio=RATIO,
                                  capacity_factor=cf)})
    ranks = collect(start(cases, 4, root / "w4"))
    yield {c["name"]: [r[c["name"]] for r in ranks] for c in cases}, jax_out, inputs, (x, probe)
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("name", list(CASES))
def test_expert_parallel_output_and_aux_match(runs, name):
    res, jax_out, inputs, (x, probe) = runs
    y_ref, aux_ref, _, _ = _whole(*inputs[name], x, probe)
    for r in res[name]:
        assert not r["modules"]  # the ranks load no jax
        np.testing.assert_allclose(r["y"].numpy(), y_ref.numpy(), **TOL)
        np.testing.assert_allclose(float(r["aux"]), float(aux_ref), **TOL)
        np.testing.assert_allclose(r["y"].numpy(), jax_out[name][0], **TOL)
        np.testing.assert_allclose(float(r["aux"]), jax_out[name][1], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_expert_gradients_are_the_slices_of_the_whole_modules(runs, name):
    res, _, inputs, (x, probe) = runs
    ep = CASES[name][0]
    _, _, dx, grads = _whole(*inputs[name], x, probe)
    per = E // ep
    for r in res[name]:
        i = r["coords"]["ep"]
        for key, g in grads.items():
            want = g[i * per: (i + 1) * per] if key in EXPERT_LEAVES else g
            assert r["shapes"][key] == tuple(want.shape), key
            np.testing.assert_allclose(r["grads"][key].numpy(), want.numpy(), **TOL,
                                       err_msg=key)
        np.testing.assert_allclose(r["dx"].numpy(), dx.numpy(), **TOL)


def test_expert_parallel_needs_ep_to_divide_the_experts():
    with pytest.raises(ValueError, match="8 experts do not split over ep=3"):
        expert_parallel_(MoEFFN(W, E, RATIO), Shard(None, 0, 3))
