"""Shared fixtures of the benchmark's CPU tests: the cells at a size a test
run holds (the widths cut, the code paths the cells' own)."""
import time

import pytest
import torch

from portbench import harness


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's hand-written kernels); skips with "
        "a reason where torch.cuda is unavailable")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_train_cell() -> harness.Cell:
    """fnd_tower.train_f32_b512 at a test's size: a tower of 192 (the
    text feature width), 2 heads, fusion and classifier 32, GCN 16, 96
    records, batch 16 (the graph's node slices are the program's own)."""
    cell = harness.load_cell("fnd_tower.train_f32_b512")
    c = cell.config
    c["tower"].update(width=192, heads=2)
    c["fusion"]["hidden"] = 32
    c["classifier"]["hidden"] = 32
    c["gnn"]["dim"] = 16
    c["corpus"].update(n=96, text=192, audio=32, visual=128, temporal=64, ocr_vocab=64,
                       ocr_topics=4)
    cell.traffic.update(batch_size=16, host_units=2)
    return cell


def tiny_bert_cell(width: int = 32, heads: int = 2) -> harness.Cell:
    """bert_base_uncased.encode_fields_r12 at a test's size: width 32, two
    layers, requests of 2 records of 1-3 strings of 4-20 tokens."""
    cell = harness.load_cell("bert_base_uncased.encode_fields_r12")
    c = cell.config
    c.update(hidden_size=width, num_hidden_layers=2, num_attention_heads=heads,
             intermediate_size=2 * width, vocab_size=1200)
    c["ladder"].update(dim=width, batch_size=16, max_length=32)
    cell.traffic.update(pool=4, records=2, check_requests=3, host_units=2)
    cell.traffic["fields"] = [{"name": "text", "p": 1.0, "count": [1, 3], "tokens": [4, 20]}]
    return cell


def run_tiny(cell, seed=2 ** 31 + 11, seconds=0.5, trace=False, control=False, device="cpu"):
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device=device,
                            control=control)
