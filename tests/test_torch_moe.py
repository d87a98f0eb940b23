"""PyTorch port, `models/moe.py`, the MoE tower and the MoE trainer step,
against the JAX package on the CPU (width 64, E = 4, S = 16; the tower at
depth 2, the trainer's at depth 1).

Routing is discontinuous: a router logit one ulp away can move a near-tie
token to another expert and, through the capacity count, shift the slots
of later tokens. So each comparison first asserts that the expert and the
slot of every token are equal in both packages, on inputs whose smallest
top-1 / top-2 router probability margin exceeds 1e-5 (each test measures
the margin of its seed on the JAX side and asserts it). Weights cross from
the Flax params by `utils/transfer.tower_state_dict`; dropout is off.

Tolerances: the FFN's and the block's out within 1e-5 of max|out|, their
aux within 1e-6 relative; the tower's pooled output within 1e-5 and its
aux within 1e-6 relative; gradients (tower and trainer step) within 1e-4 of
each leaf's largest value; the bf16 tower against the JAX bf16 tower on the
Pallas kernels in interpret mode at the bounds of
`test_torch_bf16_training.py` (pooled 2e-2, gradients 3e-2 of each leaf's
largest). Expert weights start from Flax's `lecun_normal` on their 3-D
shape: std 1 / sqrt(E * in) (0.01276 at E = 8, in = 768).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.models.moe import MoEEncoderBlock as JaxMoEBlock
from ultrafnd_git_tpu.models.moe import MoEFFN as JaxMoEFFN
from ultrafnd_git_tpu.models.transformer import TextTransformer as JaxTextTransformer
from ultrafnd_git_tpu_torch.models.initializers import jax_init_
from ultrafnd_git_tpu_torch.models.moe import MoEEncoderBlock, MoEFFN
from ultrafnd_git_tpu_torch.models.transformer import TextTransformer
from ultrafnd_git_tpu_torch.training import trainer as port
from ultrafnd_git_tpu_torch.utils.transfer import port_state_dicts, tower_state_dict

B, S, W, E, HEADS, VOCAB = 4, 16, 64, 4, 4, 512
OUT_REL = 1e-5
AUX_REL = 1e-6
GRAD_REL = 1e-4
MARGIN = 1e-5
BF16_OUT = 2e-2  # test_torch_bf16_training.py: the bf16 Predictor's envelope
BF16_GRAD = 3e-2  # test_torch_bf16_training.py's TOWER_REL


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side of these tests runs small tensors, which one thread
    computes faster than a pool that parallel test workers oversubscribe;
    the previous count comes back after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, b=B, s=S, w=W):
    return np.random.default_rng(seed).standard_normal((b, s, w)).astype(np.float32)


def _tokens(seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, size=(b, s)).astype(np.int32)
    lengths = np.array([s, 5, 1, 11][:b])  # full and padded records
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.float32)
    return ids * mask.astype(np.int32), mask


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _ffn_state(p):
    sd = {"router.weight": np.asarray(p["router"]["kernel"]).T,
          "router.bias": np.asarray(p["router"]["bias"])}
    sd.update({k: np.asarray(p[k]) for k in ("w_in", "b_in", "w_out", "b_out")})
    return {k: _t(v) for k, v in sd.items()}


def _jax_route(logits, cap):
    """(expert, slot, smallest top-1/top-2 margin) from the JAX router's
    logits, with the JAX module's formulas."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    expert = probs.argmax(-1)
    onehot = np.eye(probs.shape[1], dtype=np.int64)[expert]
    slot = (np.cumsum(onehot, 0) * onehot).sum(-1) - 1
    top2 = np.sort(probs, axis=-1)[:, -2:]
    return expert, slot, float((top2[:, 1] - top2[:, 0]).min()), cap


def _jax_router_logits(module, variables, *args, **kw):
    """(output, [router logits of each MoE FFN, in call order])."""
    out, state = module.apply(variables, *args, capture_intermediates=lambda m, n: m.name == "router",
                              mutable=["intermediates"], **kw)
    found = []

    def walk(node):
        for key in sorted(node, key=lambda k: (not k.startswith("block"), k)):
            val = node[key]
            if key == "router":
                found.append(np.asarray(val["__call__"][0]))
            elif isinstance(val, dict):
                walk(val)

    walk(jax.device_get(state["intermediates"]))
    return out, found


def _port_routes(tower):
    """Forward pre-hooks that record (expert, slot, capacity) of every MoE
    FFN call; returns (records, handles)."""
    seen, handles = [], []
    for mod in tower.modules():
        if isinstance(mod, MoEFFN):
            def hook(m, args):
                with torch.no_grad():
                    _, _, expert, _, slot = m.route(args[0])
                seen.append((expert.numpy(), slot.numpy(), m.capacity(expert.numel())))
            handles.append(mod.register_forward_pre_hook(hook))
    return seen, handles


def _assert_routes(port_routes, jax_logits):
    assert len(port_routes) == len(jax_logits) > 0
    for (expert, slot, cap), logits in zip(port_routes, jax_logits):
        j_expert, j_slot, margin, _ = _jax_route(logits, cap)
        assert margin > MARGIN, f"seed gives a near tie: margin {margin}"
        np.testing.assert_array_equal(expert, j_expert)
        np.testing.assert_array_equal(slot, j_slot)


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max()
                 / max(np.abs(np.asarray(b, np.float32)).max(), 1e-30))


@pytest.mark.parametrize("shape,gelu,cf", [
    pytest.param((2, 8, 32), "tanh", 1.25, id="w32"),
    pytest.param((B, S, W), "tanh", 1.25, id="w64"),
    pytest.param((B, S, W), "exact", 2.0, id="w64_exact_gelu_cf2"),
])
def test_moe_ffn_matches_jax(shape, gelu, cf):
    x = _x(1, *shape)
    jm = JaxMoEFFN(shape[2], num_experts=E, capacity_factor=cf, gelu=gelu)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    (y_ref, aux_ref), logits = _jax_router_logits(jm, {"params": params}, jnp.asarray(x))
    m = MoEFFN(shape[2], E, capacity_factor=cf, gelu=gelu)
    m.load_state_dict(_ffn_state(params))
    routes, _ = _port_routes(m)
    with torch.no_grad():
        y, aux = m(_t(x))
    _assert_routes(routes, logits)
    assert _rel(y, y_ref) <= OUT_REL
    assert abs(float(aux) - float(aux_ref)) <= AUX_REL * abs(float(aux_ref))


def test_dropped_tokens_pass_through_as_zeros():
    """Capacity factor 0.25: C = ceil(64 * 0.25 / 4) = 4 slots an expert for
    64 tokens, so most tokens drop; a dropped token's FFN output is exactly
    0 in both packages (the block adds nothing to its residual)."""
    x = _x(2)
    jm = JaxMoEFFN(W, num_experts=E, capacity_factor=0.25)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    (y_ref, aux_ref), logits = _jax_router_logits(jm, {"params": params}, jnp.asarray(x))
    m = MoEFFN(W, E, capacity_factor=0.25)
    m.load_state_dict(_ffn_state(params))
    routes, _ = _port_routes(m)
    with torch.no_grad():
        y, aux = m(_t(x))
    _assert_routes(routes, logits)
    expert, slot, cap = routes[0]
    dropped = slot >= cap
    assert cap == 4 and dropped.sum() >= B * S // 2
    y, y_ref = y.numpy().reshape(-1, W), np.asarray(y_ref).reshape(-1, W)
    assert (y[dropped] == 0).all() and (y_ref[dropped] == 0).all()
    assert (np.abs(y[~dropped]).sum(-1) > 0).all()
    assert _rel(y, y_ref) <= OUT_REL
    assert abs(float(aux) - float(aux_ref)) <= AUX_REL * abs(float(aux_ref))


def test_moe_block_matches_jax():
    x = _x(3)
    _, mask = _tokens(3)
    jb = JaxMoEBlock(W, HEADS, num_experts=E)
    params = jb.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask))["params"]
    (y_ref, aux_ref), logits = _jax_router_logits(jb, {"params": params}, jnp.asarray(x),
                                                  jnp.asarray(mask), deterministic=True)
    sd = tower_state_dict({"tok_embed": {"embedding": np.zeros((2, W), np.float32)},
                           "pos_embed": np.zeros((1, S, W), np.float32),
                           "ln_embed": params["ln1"], "ln_final": params["ln1"],
                           "block0": jax.device_get(params)})
    block = MoEEncoderBlock(W, HEADS, num_experts=E)
    block.load_state_dict({k[len("blocks.0."):]: _t(v) for k, v in sd.items()
                           if k.startswith("blocks.0.")})
    routes, _ = _port_routes(block)
    with torch.no_grad():
        y, aux = block(_t(x), _t(mask))
    _assert_routes(routes, logits)
    assert _rel(y, y_ref) <= OUT_REL
    assert abs(float(aux) - float(aux_ref)) <= AUX_REL * abs(float(aux_ref))


def _towers(dtype=None, seed=4, heads=HEADS, **jax_kw):
    kw = dict(width=W, depth=2, heads=heads, vocab_size=VOCAB, max_len=S, gelu="tanh",
              moe_experts=E)
    jt = JaxTextTransformer(**kw, **jax_kw,
                            dtype=None if dtype is None else jnp.bfloat16)
    ids, mask = _tokens(seed)
    params = jt.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask),
                     deterministic=True)["params"]
    pt = TextTransformer(**kw, dtype=dtype)
    pt.load_state_dict({k: _t(v) for k, v in tower_state_dict(jax.device_get(params)).items()})
    return jt, params, pt, ids, mask


@pytest.mark.parametrize("bf16", [pytest.param(False, id="f32"), pytest.param(True, id="bf16")])
def test_moe_tower_pooled_aux_and_gradients_match_jax(bf16):
    """loss = sum(pooled * w) + aux through `return_aux`; in bf16 the JAX
    tower runs the Pallas bf16 kernels in interpret mode (K2, K3, K4) at
    one head of 64 (a width the Pallas kernels take), as the port's tower
    runs K2's and K3/K4's bf16 modes on a GPU."""
    if bf16:
        jt, params, pt, ids, mask = _towers(torch.bfloat16, seed=5, heads=1,
                                            attention_backend="interpret")
    else:
        jt, params, pt, ids, mask = _towers()
    w = np.random.default_rng(6).standard_normal((B, W)).astype(np.float32)
    (pooled_ref, aux_ref), logits = _jax_router_logits(
        jt, {"params": params}, jnp.asarray(ids), jnp.asarray(mask), deterministic=True,
        return_aux=True)

    def loss(p):
        pooled, aux = jt.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                               deterministic=True, return_aux=True)
        return (pooled * w).sum() + aux

    ref = tower_state_dict(jax.device_get(jax.grad(loss)(params)))
    routes, _ = _port_routes(pt)
    pooled, aux = pt(_t(ids).long(), _t(mask), return_aux=True)
    ((pooled * _t(w)).sum() + aux).backward()
    _assert_routes(routes[: len(logits)], logits)
    out_bound, grad_bound = (BF16_OUT, BF16_GRAD) if bf16 else (OUT_REL, GRAD_REL)
    assert _rel(pooled.detach(), pooled_ref) <= out_bound
    assert abs(float(aux) - float(aux_ref)) <= (1e-3 if bf16 else AUX_REL) * abs(float(aux_ref))
    grads = {n: p.grad for n, p in pt.named_parameters()}
    assert set(grads) == set(ref)
    worst = max(((n, _rel(g, ref[n])) for n, g in grads.items()), key=lambda kv: kv[1])
    assert worst[1] <= grad_bound, worst


def test_expert_weights_start_from_flax_lecun_normal_on_their_3d_shape():
    """fan_in of an (E, in, out) array is E * in in Flax; the draws differ
    from Flax's (other generator), the distribution must not."""
    from flax import linen as nn

    e, w, h = 8, 768, 3072
    ffn = jax_init_("text_tower", MoEFFN(w, e), torch.Generator().manual_seed(0))
    ref = np.asarray(nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (e, w, h)))
    expect = 1.0 / np.sqrt(e * w)
    assert abs(expect - 0.01276) < 1e-5
    for name, fan_in in (("w_in", e * w), ("w_out", e * h)):
        std = float(getattr(ffn, name).std())
        assert abs(std - 1.0 / np.sqrt(fan_in)) <= 1e-2 / np.sqrt(fan_in), (name, std)
    assert abs(float(ffn.w_in.std()) - float(ref.std())) <= 1e-2 * float(ref.std())
    assert float(ffn.w_in.abs().max()) <= 2 * expect / 0.87962566 + 1e-7  # truncated at 2 std
    for name in ("b_in", "b_out"):
        assert not getattr(ffn, name).any()
    assert float(ffn.router.weight.std()) == pytest.approx(1 / np.sqrt(w), rel=5e-2)


# ---------------------------------------------------------------------------
# the trainer's MoE step against JAX's _make_grad_fn


def small_cache(n=48, width=W, seq=S, seed=0):
    """A synthetic feature cache with a narrow text width and short token
    rows (the tower's width is the cache's text width)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 400, size=(n, seq)).astype(np.int32)
    lengths = rng.integers(2, seq + 1, size=n)
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.float32)
    order = rng.permutation(n)
    return {
        "ids": [f"r{i}" for i in range(n)],
        "labels": (np.arange(n) % 2).astype(np.int64),
        "text": rng.standard_normal((n, width)).astype(np.float32),
        "audio": rng.standard_normal((n, 128)).astype(np.float32),
        "visual": rng.standard_normal((n, 512)).astype(np.float32),
        "temporal": rng.standard_normal((n, 256)).astype(np.float32),
        "aux": rng.uniform(size=(n, 2)).astype(np.float32),
        "evidence": rng.uniform(size=(n, 3)).astype(np.float32),
        "text_ids": ids * mask.astype(np.int32),
        "text_mask": mask,
        "ocr_sets": [set(f"t{j}" for j in rng.choice(24, 4, replace=False)) for _ in range(n)],
        "split": (np.sort(order[: n * 2 // 3]), np.sort(order[n * 2 // 3: n * 5 // 6]),
                  np.sort(order[n * 5 // 6:])),
    }


MOE_TRAINER = dict(batch_size=8, epochs=1, seed=0, train_text_tower=True, text_tower_depth=1,
                   text_tower_heads=HEADS, moe_experts=E)


@pytest.fixture(scope="module")
def moe_trainers(tmp_path_factory):
    """The JAX trainer on a small cache, its modules cloned with dropout 0
    (so `_make_grad_fn`, which trains with dropout on, computes the
    dropout-off gradient), and a port trainer on the same cache carrying
    its initial params."""
    from ultrafnd_git_tpu.training.trainer import ForensicTrainer, TrainConfig

    cache = small_cache()
    jt = ForensicTrainer(TrainConfig(data_root="unused", out_dir=str(tmp_path_factory.mktemp("jmoe")),
                                     cache_to_disk=False, log_metrics_jsonl=False,
                                     **MOE_TRAINER), cache=cache)
    jt.text_tower = jt.text_tower.clone(dropout=0.0)
    jt.fusion = jt.fusion.clone(dropout=0.0)
    jt.clf = jt.clf.clone(dropout=0.0, node_dropout=0.0)
    jt.gnn = jt.gnn.clone(dropout=0.0)
    pt = port.ForensicTrainer(port.TrainConfig(out_dir=str(tmp_path_factory.mktemp("pmoe")),
                                               cache_to_disk=False, **MOE_TRAINER),
                              cache=cache, device="cpu")
    sds = port_state_dicts(jax.device_get(jt.state.params), None, node_tau=10.0)
    for part, mod in pt.state.params.items():
        mod.load_state_dict({k: _t(v) for k, v in sds[part].items()})
    return jt, pt


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_moe_step_gradient_matches_jax(moe_trainers, accum):
    """One optimizer step's rows (a ragged last microbatch) through JAX's
    `_make_grad_fn` and the port's `grads_of`: the aux joins every row's
    loss, so with grad_accum each microbatch's aux weighs by its valid
    rows, in both."""
    jt, pt = moe_trainers
    n = 8 * accum
    idx = np.asarray(jt.tr_idx[:n], np.int32).copy()
    idx[n - 3:] = idx[n - 4]  # the padding repeats the last valid row
    mask = (np.arange(n) < n - 3).astype(np.float32)

    # routes of the step's microbatches, JAX tower against the port's
    tower = pt.state.params["text_tower"]
    routes, handles = _port_routes(tower)
    logits = []
    try:
        for i in np.split(idx, accum):
            ids, m = jt.cache["text_ids"][i], jt.cache["text_mask"][i].astype(np.float32)
            logits += _jax_router_logits(jt.text_tower, {"params": jt.state.params["text_tower"]},
                                         jnp.asarray(ids), jnp.asarray(m), deterministic=True)[1]
            with torch.no_grad():
                tower(_t(ids).long(), _t(m))
    finally:
        for h in handles:
            h.remove()
    _assert_routes(routes, logits)

    jt.cfg.grad_accum = pt.cfg.grad_accum = accum
    try:
        loss_ref, g_ref, _ = jt._make_grad_fn()(jt.state, jnp.asarray(idx), jnp.asarray(mask),
                                                jt.corpus)
        loss, grads, (p1, forensic) = pt.grads_of(_t(idx).long(), _t(mask))
    finally:
        jt.cfg.grad_accum = pt.cfg.grad_accum = 1
    ref = port_state_dicts(jax.device_get(g_ref), None, node_tau=10.0)
    assert p1.shape == (n,) and forensic.shape == (3, n)
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * max(1.0, abs(float(loss_ref)))
    assert "moe.w_in" in "".join(grads["text_tower"])
    for part, leaves in grads.items():
        for name, g in leaves.items():
            assert _rel(g, ref[part][name]) <= GRAD_REL, (part, name)
