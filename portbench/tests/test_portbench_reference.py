"""The plain references against the port on the CPU, at a test's size.

The tests may import the port; the references may not. Both sides run in
f32 on the CPU with the same weights and inputs, so they differ only in the
order of their sums (the port's padding bias against the reference's
masked softmax, its fused chunks, its Flax-order layer norms)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from portbench import weights
from portbench.corpus import make_corpus
from portbench.reference import bert_encoder, fnd_v2_step
from portbench.tests.conftest import run_tiny, tiny_bert_cell, tiny_train_cell

ROOT = Path(__file__).resolve().parents[2]
# f32 on both sides; sums in another order move the last few bits of a
# row's elements (about 1e-7 of a unit row): 1e-5 leaves room and is still
# a hundred times under what a wrong layer gives
ROW_TOL = 1e-5


def test_bert_reference_matches_the_port():
    from ultrafnd_git_tpu_torch.models.bert import DeviceBertEncoder

    cfg = tiny_bert_cell().config
    wts = weights.draw(bert_encoder.param_spec(cfg), 7, "cpu")["bert"]
    enc = DeviceBertEncoder(wts, None, dim=cfg["ladder"]["dim"], max_length=32, batch_size=16,
                            device="cpu", config=cfg)
    rng = np.random.default_rng(0)
    lengths = np.array([3, 17, 9, 32, 1])
    ids = rng.integers(999, cfg["vocab_size"], size=(5, 32))
    mask = (np.arange(32)[None] < lengths[:, None]).astype(np.float32)
    ids[mask == 0] = 0
    got = torch.as_tensor(enc.encode_ids(ids, mask))
    want = bert_encoder.encode(cfg, wts, torch.as_tensor(ids), torch.as_tensor(mask),
                               cfg["ladder"]["dim"])
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < ROW_TOL


def test_reference_graph_matches_the_port():
    from ultrafnd_git_tpu_torch.ops.graphctx import build_graph_context

    cfg = tiny_train_cell().config
    corpus = make_corpus(cfg, 3)
    a_norm, ax = fnd_v2_step.graph(cfg, corpus, "cpu")
    ctx = build_graph_context(corpus, cfg["gnn"]["overlap_thresh"])
    edges = int((ctx.a_norm > 0).sum()) - len(ctx.a_norm)
    assert edges > 0  # the topics link records
    # 0/1 adjacency and its degrees are exact; a_norm and ax to f32 rounding
    assert np.array_equal(a_norm.numpy() > 0, ctx.a_norm > 0)
    np.testing.assert_allclose(a_norm.numpy(), ctx.a_norm, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ax.numpy(), ctx.ax, rtol=1e-5, atol=1e-6)


def test_train_reference_follows_the_port_step_for_step():
    out = run_tiny(tiny_train_cell(), control=True)
    numbers = {k: c["value"] for k, c in out["checks"].items()}
    # f32 both sides: the losses agree to rounding; the median leaf's
    # first-gradient norm to 1e-6 of its own; its change after three Adam
    # steps to 1e-5 (Adam divides a leaf's tiniest gradients by their own
    # root mean square, so the change carries a little more of the rounding)
    assert numbers["loss"] < 1e-6
    assert numbers["grad1_median"] < 1e-6
    assert numbers["change3_median"] < 1e-5
    assert out["result"]["correct"]


def test_references_import_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.fnd_v2_step, portbench.reference.bert_encoder\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ultrafnd_git_tpu', 'ultrafnd_git_tpu_torch')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n") % str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
