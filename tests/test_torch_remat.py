"""PyTorch port, `remat_tower`: the rematerialised tower against the plain
one, bit for bit.

Each block draws its two dropout masks from the step's generator before it
computes anything, and hands them to its body, which `torch.utils.checkpoint`
recomputes in the backward. So remat on and off must give the same bits:
the same loss and gradients, the same parameters after two dropout-on
AdamW steps, and the generator in the same state (JAX asserts the same of
its `nn.remat`, tests/test_text_device_tower.py and tests/test_moe.py).
Dense and MoE blocks, on the CPU, where the kernel wrappers run their plain
versions. Tolerance: none (torch.equal).
"""
import numpy as np
import pytest
import torch

from test_torch_moe import one_torch_thread, small_cache  # noqa: F401 (autouse fixture)
from ultrafnd_git_tpu_torch.models.initializers import seeded_init_
from ultrafnd_git_tpu_torch.models.transformer import TextTransformer
from ultrafnd_git_tpu_torch.training import trainer as port


@pytest.mark.parametrize("experts", [pytest.param(0, id="dense"), pytest.param(4, id="moe")])
def test_remat_tower_gradients_and_generator_are_bit_identical(experts):
    kw = dict(width=64, depth=2, heads=4, vocab_size=512, max_len=16, moe_experts=experts)
    plain = seeded_init_(TextTransformer(**kw), torch.Generator().manual_seed(0))
    remat = TextTransformer(**kw, remat=True)
    remat.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 512, size=(4, 16)))
    mask = torch.from_numpy((np.arange(16)[None] < np.array([[16], [5], [1], [11]])).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    out, calls = {}, {"plain": 0, "remat": 0}
    for name, tower in (("plain", plain), ("remat", remat)):
        for block in tower.blocks:  # count the block bodies run, recomputes included
            def body(*args, _f=block.body, _name=name):
                calls[_name] += 1
                return _f(*args)
            block.body = body
        gen = torch.Generator().manual_seed(7)
        pooled, aux = tower(ids, mask, gen, return_aux=True)
        ((pooled * w).sum() + aux).backward()
        out[name] = (pooled.detach(), aux.detach(), gen.get_state(),
                     {n: p.grad for n, p in tower.named_parameters()})
    assert calls == {"plain": 2, "remat": 4}  # the recompute ran each block again
    (p0, a0, g0, d0), (p1, a1, g1, d1) = out["plain"], out["remat"]
    assert torch.equal(p0, p1) and torch.equal(a0, a1) and torch.equal(g0, g1)
    assert d0.keys() == d1.keys()
    for n in d0:
        assert torch.equal(d0[n], d1[n]), n


@pytest.mark.parametrize("experts", [pytest.param(0, id="dense"), pytest.param(4, id="moe")])
def test_remat_trainer_steps_are_bit_identical(tmp_path, experts):
    """Two dropout-on train steps of the trainer, remat on and off: losses,
    the next step's gradients, the parameters, the AdamW moments and the
    dropout generator all equal."""
    cache = small_cache()
    trainers = [
        port.ForensicTrainer(port.TrainConfig(
            out_dir=str(tmp_path / f"r{remat}"), cache_to_disk=False, batch_size=8, epochs=1,
            seed=0, train_text_tower=True, text_tower_depth=2, text_tower_heads=4,
            moe_experts=experts, remat_tower=remat), cache=cache, device="cpu")
        for remat in (False, True)
    ]
    assert trainers[1].state.params["text_tower"].remat
    batches = trainers[0].epoch_batches(trainers[0].tr_idx, True)[:3]
    losses = [[], []]
    for t, out in zip(trainers, losses):
        for mod in t.state.params.values():
            mod.train(True)
        for chunk, mask, _ in batches[:2]:
            out.append(t.train_step(chunk, mask)[0])
    assert all(torch.equal(a, b) for a, b in zip(*losses))
    chunk, mask, _ = batches[2]
    grads = [t.grads_of(torch.from_numpy(chunk).long(), torch.from_numpy(mask), t.state.gen)[1]
             for t in trainers]
    for part, leaves in grads[0].items():
        for name, g in leaves.items():
            assert torch.equal(g, grads[1][part][name]), (part, name)
    s0, s1 = (t.state.state_dict() for t in trainers)
    assert torch.equal(s0["rng"], s1["rng"]) and int(s0["step"]) == int(s1["step"]) == 2
    for part in s0["params"]:
        for k, v in s0["params"][part].items():
            assert torch.equal(v, s1["params"][part][k]), (part, k)
        for key in ("mu", "nu"):
            for k, v in s0["opt_state"][key][part].items():
                assert torch.equal(v, s1["opt_state"][key][part][k]), (key, part, k)
