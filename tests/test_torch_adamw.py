"""PyTorch port, K1's plain version and the optimizer against the JAX package.

`adamw_reference_` (through the port's `AdamW` and, on CPU tensors,
`FusedAdamW`) against the JAX `FusedAdamW.apply` and the optax chain
`clip_by_global_norm -> adamw`, over 3 steps on a random tree with the
same grads, with and without a frozen subtree, with the clip engaged and
not. Tolerance: atol 1e-7 times the leaf's largest |p| (about one f32 ulp
of the largest parameter); bit identity is not expected, because the
global norm sums in another order in the two frameworks. The staircase
schedule is compared exactly. The kernel itself is held to the plain
version bit for bit on a GPU: tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ultrafnd_git_tpu.training.state import make_optimizer as jax_make_optimizer
from ultrafnd_git_tpu_torch.kernels import adamw as aw
from ultrafnd_git_tpu_torch.training.state import make_optimizer

SHAPES = {"fusion": {"a": (700, 150), "b": (150,)},
          "clf": {"w": (300, 300), "t": ()},
          "gnn": {"k": (416, 256)}}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {part: {n: rng.normal(size=s).astype(np.float32) for n, s in leaves.items()}
            for part, leaves in SHAPES.items()}


def _modules(tree):
    return {part: nn.ParameterDict({n: nn.Parameter(torch.tensor(a)) for n, a in d.items()})
            for part, d in tree.items()}


def _grads(seed, steps, scale):
    return [{p: {n: a * np.float32(scale) for n, a in d.items()} for p, d in t.items()}
            for t in (_tree(seed + 100 + k) for k in range(steps))]


def _run_port(fused, p0, grads, frozen):
    tx = make_optimizer(2e-4, 1e-4, 5.0, steps_per_epoch=1, frozen_subtrees=frozen)
    assert isinstance(tx, aw.FusedAdamW)  # the trainer's only route
    if not fused:  # the plain version, on the same schedule and settings
        tx = aw.AdamW(tx.schedule, tx.weight_decay, tx.grad_clip, frozen_subtrees=frozen)
    params = _modules(p0)
    state = tx.init(params)
    for g in grads:
        tx.apply(params, state, {p: {n: torch.tensor(a) for n, a in d.items()}
                                 for p, d in g.items()})
    return {p: {n: t.detach().numpy() for n, t in m.items()} for p, m in params.items()}, state


def _run_jax(fused, p0, grads, frozen):
    tx = jax_make_optimizer(2e-4, 1e-4, 5.0, steps_per_epoch=1, frozen_subtrees=frozen,
                            fused=fused)
    if fused:
        step = jax.jit(tx.apply)
    else:
        @jax.jit
        def step(p, o, g):
            up, o = tx.update(g, o, p)
            return optax.apply_updates(p, up), o
    p, o = p0, tx.init(p0)
    for g in grads:
        p, o = step(p, o, g)
    return jax.device_get(p)


# grad scale 0.005: global norm ~2.7 (under the clip of 5); 1.0: ~550 (clipped)
@pytest.mark.parametrize("scale", [0.005, 1.0], ids=["clip_idle", "clip_engaged"])
@pytest.mark.parametrize("frozen", [(), ("gnn",)], ids=["all", "frozen_gnn"])
def test_plain_update_matches_jax_fused_and_optax(scale, frozen):
    p0 = _tree(0)
    grads = _grads(0, 3, scale)
    gnorm = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                        for p, d in grads[0].items() if p not in frozen for a in d.values()))
    assert (gnorm > 5.0) == (scale == 1.0)
    before = aw.launches
    ours, state = _run_port(False, p0, grads, frozen)
    ours_fused, _ = _run_port(True, p0, grads, frozen)
    assert aw.launches == before  # CPU tensors: the plain version, no launch
    assert state["count"] == 3
    for ref in (_run_jax(True, p0, grads, frozen), _run_jax(False, p0, grads, frozen)):
        for part, leaves in ref.items():
            for name, r in leaves.items():
                atol = 1e-7 * max(1.0, float(np.abs(r).max()))
                np.testing.assert_allclose(ours[part][name], r, rtol=0, atol=atol,
                                           err_msg=f"{part}.{name}")
                np.testing.assert_array_equal(ours_fused[part][name], ours[part][name])
    for part in frozen:
        for name, a in p0[part].items():
            np.testing.assert_array_equal(ours[part][name], a)
            assert not state["mu"][part][name].any()
    moved = [n for n in p0["fusion"] if not np.array_equal(ours["fusion"][n], p0["fusion"][n])]
    assert moved == ["a", "b"]


def test_staircase_schedule_matches_optax_exactly():
    from ultrafnd_git_tpu_torch.training.state import staircase_schedule

    for lr, steps, rate in ((2e-4, 9, 0.7), (1e-3, 24, 0.7), (3e-4, 1, 0.5)):
        ref = optax.exponential_decay(init_value=lr, transition_steps=steps,
                                      decay_rate=rate, staircase=True)
        ours = staircase_schedule(lr, steps, rate)
        for count in range(0, 12 * steps + 1):
            expect = np.float32(ref(np.int32(count)))
            assert np.float32(ours(count)) == expect, (lr, steps, count)


def test_adamw_reference_is_optax_order_one_leaf():
    """One leaf, one step, by hand: clip -> moments -> bias-corrected ratio
    -> decoupled decay -> -lr, each op rounded in f32."""
    rng = np.random.default_rng(3)
    p, g = rng.normal(size=(64,)).astype(np.float32), rng.normal(size=(64,)).astype(np.float32)
    m, v = np.zeros(64, np.float32), np.zeros(64, np.float32)
    tx = aw.AdamW(lambda c: 1e-3, weight_decay=1e-2, grad_clip=1.0)
    scal = tx.scalars({"x": {"g": torch.tensor(g)}}, 0)
    gnorm = np.float32(scal[0])
    assert gnorm > 1.0  # the clip is engaged
    tp, tm, tv = (torch.tensor(x) for x in (p, m, v))
    aw.adamw_reference_(tp, tm, tv, torch.tensor(g), scal)
    f = np.float32
    gc = (g / gnorm) * f(1.0)
    m1 = f(1 - 0.9) * gc + f(0.9) * m
    v1 = f(1 - 0.999) * (gc * gc) + f(0.999) * v
    u = (m1 / f(0.1)) / (np.sqrt(v1 / (f(1) - f(0.999))) + f(1e-8)) + f(1e-2) * p
    np.testing.assert_allclose(tp.numpy(), p + f(-1e-3) * u, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(tm.numpy(), m1)
    np.testing.assert_array_equal(tv.numpy(), v1)


def test_kernel_route_rejects_what_it_cannot_take():
    p = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no AdamW kernel"):
        aw.fused_adamw_([(p, p, p, p)], torch.zeros(16, device="meta"))


@pytest.mark.parametrize("numels", [[1, 3, 4, 4097], [4096, 8192, 1], [0, 5, 0, 12289]],
                         ids=["odd", "whole_chunks", "empty_leaves"])
def test_block_entries_cover_every_chunk_once(numels):
    """K1's per-block table: each leaf's ceil(numel / chunk) chunks, in leaf
    order, each named once as (leaf << 32) | chunk."""
    chunk = 4096
    entries = aw.block_entries(numels, chunk)
    want = [(leaf << 32) | c for leaf, n in enumerate(numels) for c in range(-(-n // chunk))]
    assert entries.dtype == np.int64 and entries.tolist() == want
