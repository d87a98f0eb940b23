"""The yardstick's arithmetic, by hand-worked cases: kernel work counted
once from shapes, bounds against the H100's peaks, model FLOPs."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.flops import bert_base_uncased as bert_flops
from portbench.flops import fnd_tower as tower_flops
from portbench.peaks import PEAKS
from portbench.reference import bert_encoder, fnd_v2_step
from portbench.rooflines import bound_by, bound_s, k2, k3k4
from portbench.tests.conftest import tiny_bert_cell, tiny_train_cell

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def test_k2_at_the_tower_shape_is_bound_by_bytes():
    # q, k, v, out: 4 x 512*6*64*128 floats; bias 512*64; lse 512*6*64
    flop, nbytes = k2.work((512, 6, 64, 128))
    assert nbytes == 4 * (4 * 25_165_824 + 32_768 + 196_608) == 403_570_688
    assert flop == 4 * 512 * 6 * 64 * 64 * 128 == 6_442_450_944
    assert bound_by((flop, nbytes), H100, "tf32") == "bytes"
    assert bound_s((flop, nbytes), H100, "tf32") * 1e3 == pytest.approx(0.120469, abs=1e-6)


def test_k2_at_the_bert_shape_is_bound_by_bytes_not_operations():
    # operations alone: 5.15e10 / 495e12 = 0.104 ms; but q, k, v and out are
    # 805 MB, 0.241 ms at 3.35 TB/s: the bytes bound it
    flop, nbytes = k2.work((256, 12, 256, 64))
    assert flop / H100["tf32"] * 1e3 == pytest.approx(0.104120, abs=1e-6)
    assert nbytes / H100["bytes_per_s"] * 1e3 == pytest.approx(0.241407, abs=1e-6)
    assert bound_by((flop, nbytes), H100, "tf32") == "bytes"


def test_k3k4_at_the_tower_shape():
    flop, nbytes = k3k4.work((512, 6, 64, 128))
    assert flop == 10 * 512 * 6 * 64 * 64 * 128
    assert nbytes == 4 * (8 * 25_165_824 + 196_608 + 32_768)
    assert bound_s((flop, nbytes), H100, "tf32") * 1e3 == pytest.approx(0.240664, abs=1e-6)


def test_bert_forward_flops_at_256_tokens():
    cfg = harness.load_cell("bert_base_uncased.encode_ocr_s256").config
    # 12 x (2*256*768*(4*768 + 2*3072) + 4*256^2*768)
    assert bert_flops.string_flops(cfg, 256) == 12 * (3_623_878_656 + 201_326_592)
    assert bert_flops.string_flops(cfg, 256) == 45_902_462_976


@pytest.mark.parametrize("impl", ["einsum", "bmm"])
def test_a_product_costs_the_same_whatever_implements_it(impl):
    b, h, s, d = 2, 3, 16, 8
    q, k, v = (torch.randn(b, h, s, d) for _ in range(3))
    with FlopCounterMode(display=False) as fc:
        if impl == "einsum":
            p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k), -1)
            torch.einsum("bhqk,bhkd->bhqd", p, v)
        else:
            p = torch.softmax(torch.bmm(q.reshape(-1, s, d), k.reshape(-1, s, d).mT), -1)
            torch.bmm(p, v.reshape(-1, s, d))
    assert fc.get_total_flops() == k2.work((b, h, s, d))[0]


def test_bert_flops_count_every_product_of_the_reference():
    cfg = tiny_bert_cell().config
    spec = bert_encoder.param_spec(cfg)
    from portbench import weights

    wts = weights.draw(spec, 3, "cpu")["bert"]
    length = 12
    ids = torch.randint(999, cfg["vocab_size"], (1, length))
    with FlopCounterMode(display=False) as fc:
        bert_encoder.encode(cfg, wts, ids, torch.ones(1, length), cfg["ladder"]["dim"])
    assert fc.get_total_flops() == bert_flops.string_flops(cfg, length)


def test_tower_flops_count_every_product_of_the_reference():
    from portbench import weights
    from portbench.corpus import make_corpus

    cfg = tiny_train_cell().config
    corpus = make_corpus(cfg, 5)
    a_norm, ax = fnd_v2_step.graph(cfg, corpus, "cpu")
    w = weights.draw(fnd_v2_step.param_spec(cfg), 5, "cpu")
    p = {f"{part}.{n}": t for part, leaves in w.items() for n, t in leaves.items()}
    data = {"a_norm": a_norm, "ax": ax, "labels": torch.as_tensor(corpus["labels"]),
            "text_ids": torch.as_tensor(corpus["text_ids"]).long(),
            "text_mask": torch.as_tensor(corpus["text_mask"])}
    for key in ("audio", "visual", "temporal", "aux"):
        data[key] = torch.as_tensor(corpus[key])
    batch = 8
    idx = torch.arange(batch)
    keep = [torch.ones(batch, cfg["tower"]["max_len"], cfg["tower"]["width"], dtype=torch.bool)] * 4
    keep += [torch.ones(cfg["corpus"]["n"], 2 * cfg["gnn"]["dim"], dtype=torch.bool),
             torch.ones(batch, 2 * cfg["fusion"]["hidden"], dtype=torch.bool),
             torch.ones(batch, cfg["fusion"]["hidden"], dtype=torch.bool),
             torch.ones(batch, cfg["classifier"]["hidden"], dtype=torch.bool),
             torch.ones(batch, cfg["classifier"]["hidden"], dtype=torch.bool),
             torch.ones(batch, cfg["classifier"]["node_trees"], 2, dtype=torch.bool)]
    with FlopCounterMode(display=False) as fc:
        fnd_v2_step.step_loss(cfg, p, data, idx, torch.ones(batch), keep)
    # the program also computes the fusion's logits head, which no loss reads
    head = 2 * batch * cfg["fusion"]["hidden"] * 2
    assert fc.get_total_flops() + head == tower_flops.forward_flops(cfg, batch)
    assert tower_flops.step_flops(cfg, batch) == 3 * tower_flops.forward_flops(cfg, batch)


def test_the_full_tower_step_counts_about_three_forward_teraflops():
    cfg = harness.load_cell("fnd_tower.train_f32_b512").config
    fwd = tower_flops.forward_flops(cfg, 512)
    assert 0.93e12 < fwd < 0.97e12  # the tower's 0.94 TFLOP and ~16 GFLOP of heads
    assert math.isclose(tower_flops.step_flops(cfg, 512), 3 * fwd)
