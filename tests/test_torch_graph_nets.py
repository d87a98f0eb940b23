"""PyTorch port, `models/graph_nets.py` against the JAX package's
(`tests/test_models.py:181`, `:204`, `:208`): the SAGE encoder and the
hetero GNN on the same weights (`utils/transfer.graph_nets_state_dict`)
within 1e-5, sentinel-padded edges inert on both sides, and `pad_edges`
equal to JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.models import graph_nets as jgn
from ultrafnd_git_tpu_torch.models import graph_nets as tgn
from ultrafnd_git_tpu_torch.utils.transfer import graph_nets_state_dict

TOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(0)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _load(mod, params):
    sd = graph_nets_state_dict(jax.device_get(params["params"]))
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return mod


def _hetero_inputs(seed, p, h, s):
    rng = np.random.default_rng(seed)
    return {"posts": rng.standard_normal((p, 16)).astype(np.float32),
            "phrases": rng.standard_normal((h, 8)).astype(np.float32),
            "sources": rng.standard_normal((s, 4)).astype(np.float32)}


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_post_encoder_matches_jax(layers):
    rng = np.random.default_rng(layers)
    x = rng.standard_normal((10, 16)).astype(np.float32)
    senders = np.array([0, 1, 2, 3, 3, 9], np.int32)
    receivers = np.array([1, 2, 3, 0, 1, 1], np.int32)
    enc = jgn.PostEncoder(hid=32, out_dim=8, layers=layers)
    params = enc.init(KEY, x, senders, receivers)
    ref = enc.apply(params, x, senders, receivers)
    ours = _load(tgn.PostEncoder(16, hid=32, out_dim=8, layers=layers), params)
    out = ours(_t(x), _t(senders).long(), _t(receivers).long())
    assert out.shape == (10, 8)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    # padded to 12 edges: the ghost edges carry nothing on either side
    s, r, mask = tgn.pad_edges(_t(senders).long(), _t(receivers).long(), 12, 10)
    js, jr, jmask = jgn.pad_edges(jnp.asarray(senders), jnp.asarray(receivers), 12, 10)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    padded = ours(_t(x), s, r)
    np.testing.assert_allclose(padded.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("sizes", [(6, 4, 3), (3, 5, 2)], ids=["more_posts", "more_phrases"])
def test_hetero_matches_jax_and_ghost_edges_are_inert(sizes):
    """(3, 5, 2) is JAX's sentinel case: more phrases than posts, so a
    single sentinel valid for one side would alias a real node of the
    other."""
    p, h, s = sizes
    nodes = _hetero_inputs(sum(sizes), p, h, s)
    pp = (np.array([0, 1, 2 % p], np.int32), np.array([0, 1, 2], np.int32))
    sp = (np.array([0, 1], np.int32), np.array([0, p - 1], np.int32))
    model = jgn.HeteroFGHGNN(hid=16, out_dim=8)
    jedges = {"post_phrase": tuple(map(jnp.asarray, pp)),
              "source_post": tuple(map(jnp.asarray, sp))}
    params = model.init(KEY, nodes, jedges)
    ref = model.apply(params, nodes, jedges)
    ours = _load(tgn.HeteroFGHGNN({"posts": 16, "phrases": 8, "sources": 4}, hid=16, out_dim=8),
                 params)
    tnodes = {k: _t(v) for k, v in nodes.items()}
    tedges = {"post_phrase": tuple(_t(a).long() for a in pp),
              "source_post": tuple(_t(a).long() for a in sp)}
    out = ours(tnodes, tedges)
    for k in ("posts", "phrases", "sources"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), **TOL)
    pp_s, pp_r, _ = tgn.pad_edges(*tedges["post_phrase"], 8, p, num_receiver_nodes=h)
    sp_s, sp_r, _ = tgn.pad_edges(*tedges["source_post"], 8, s, num_receiver_nodes=p)
    jpp = jgn.pad_edges(*jedges["post_phrase"], 8, p, num_receiver_nodes=h)
    np.testing.assert_array_equal(pp_r.numpy(), np.asarray(jpp[1]))
    padded = ours(tnodes, {"post_phrase": (pp_s, pp_r), "source_post": (sp_s, sp_r)})
    for k in ("posts", "phrases", "sources"):
        np.testing.assert_allclose(padded[k].detach().numpy(), np.asarray(ref[k]), **TOL)


def test_pad_edges_refuses_overflow():
    with pytest.raises(ValueError, match="exceeds max_edges"):
        tgn.pad_edges(torch.arange(5), torch.arange(5), 4, 5)
