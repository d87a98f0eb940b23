"""The language-model cell at a test's size on the CPU (the look for a card
skipped): a sound run is correct, and each fault of `lm_faults.py` makes
`correct` false, as `test_portbench_faults.py` does for the BERT cells.
The control (the reference with fp8 weights in the program's place) needs
the card: `python3 -m portbench.lm_faults`."""
import pytest

from portbench import harness, lm_faults
from portbench.tests.conftest import run_tiny


def tiny_lm_cell() -> harness.Cell:
    """lfm2_8b_a1b.encode_fields_r64 at a test's size: width 128, 4 layers
    (conv, conv, attention, conv), one dense layer, 8 experts top-2, two
    query heads of 64 over one KV head, the matrices' std scaled by
    sqrt(2048 / 128) so that each product keeps the published width's gain;
    requests of 2 records of 1-3 strings of 4-20 tokens, in chunks of 2."""
    cell = harness.load_cell("lfm2_8b_a1b.encode_fields_r64")
    c = cell.config
    c.update(hidden_size=128, intermediate_size=256, moe_intermediate_size=64,
             num_hidden_layers=4, layer_types=["conv", "conv", "full_attention", "conv"],
             num_attention_heads=2, num_key_value_heads=1, num_dense_layers=1, num_experts=8,
             num_experts_per_tok=2, vocab_size=1200)
    c["tokens"]["first_word"] = 10
    c["weights"]["std"] *= 4.0
    c["ladder"].update(dim=96, batch_size=2, max_length=32)  # several chunks a request
    cell.traffic.update(pool=4, records=2, check_requests=3, host_units=2)
    cell.traffic["fields"] = [{"name": "text", "p": 1.0, "count": [1, 3], "tokens": [4, 20]}]
    return cell


def test_a_sound_encode_is_correct():
    assert run_tiny(tiny_lm_cell())["result"]["correct"]


# the number each fault must at least fail (it may fail others)
CAUGHT_BY = {"no_causal_mask": "rows", "conv_not_causal": "rows", "conv_without_b_gate": "rows",
             "fp8_experts": "experts", "no_expert_bias": "routes"}


@pytest.mark.parametrize("fault", sorted(lm_faults.FAULTS))
def test_each_fault_fails(fault):
    with lm_faults.FAULTS[fault]():
        out = run_tiny(tiny_lm_cell(), seconds=0.3)
    assert not out["result"]["correct"]
    number = out["checks"][CAUGHT_BY[fault]]
    assert number["value"] > number["limit"]
