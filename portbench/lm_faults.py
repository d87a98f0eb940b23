"""Faults planted under the language-model rung's timed path, to read what
they do to the number compared (the fault tests, and on the card):

    python3 -m portbench.lm_faults --workload <cell> --seconds <s> --seeds <n> ... --fault <name>

runs `calibrate.py` with these faults beside `faults.py`'s. Each is a
context manager that breaks one piece of `models/lfm2.py` while it is open:
the attention without its causal mask, selection without `expert_bias`,
the conv reading the next token rather than the ones before (not causal),
the conv without its B gate, and the expert weights rounded to fp8 e4m3
(a scale a row), a lower precision than the configuration's bf16."""
from __future__ import annotations

import sys
from contextlib import contextmanager

import torch


@contextmanager
def _replaced(owner, name, value):
    """`owner.name` is `value` while open (the class attribute itself, so a
    staticmethod stays one)."""
    original = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, original)


def no_causal_mask():
    """The attention over every key of the string (the padding still masked)."""
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.models import lfm2

    def every_key(q, k, v, bias):
        return fa.flash_attention(q, k, v, bias) if q.dtype == torch.bfloat16 else \
            fa.reference_attention(q, k, v, bias)[0]

    return _replaced(lfm2.CausalAttention, "attend", staticmethod(every_key))


def no_expert_bias():
    """Selection by the scores alone (`expert_bias` ignored)."""
    from ultrafnd_git_tpu_torch.models import lfm2

    route = lfm2.SparseMoe.route

    def unbiased(self, x):
        kept, self.use_bias = self.use_bias, False
        try:
            return route(self, x)
        finally:
            self.use_bias = kept

    return _replaced(lfm2.SparseMoe, "route", unbiased)


def _conv(make):
    from ultrafnd_git_tpu_torch.models import lfm2

    return _replaced(lfm2.ShortConv, "forward", make(lfm2.ShortConv.forward))


def conv_not_causal():
    """The conv's window shifted one token on: it reads t - 1, t and t + 1."""
    def make(forward):
        def centred(self, x):
            gate_b, gate_c, xs = self.in_proj(x).chunk(3, dim=-1)
            bx = (gate_b * xs).transpose(1, 2)
            conv = torch.nn.functional.conv1d(bx, self.conv.weight, padding=1,
                                              groups=bx.shape[1])
            return self.out_proj(gate_c * conv.transpose(1, 2))
        return centred

    return _conv(make)


def conv_without_b_gate():
    """The conv over xs alone (its input gate B left out)."""
    def make(forward):
        def ungated(self, x):
            _, gate_c, xs = self.in_proj(x).chunk(3, dim=-1)
            conv = self.conv(xs.transpose(1, 2))[..., :x.shape[1]]
            return self.out_proj(gate_c * conv.transpose(1, 2))
        return ungated

    return _conv(make)


def fp8_experts():
    """The expert weights rounded to fp8 e4m3 as the encoder is built."""
    from portbench.drivers.lm_encode import fp8_rows_
    from ultrafnd_git_tpu_torch.models import lfm2

    build = lfm2.build

    def rounded(*args, **kwargs):
        module = build(*args, **kwargs)
        with torch.no_grad():
            for m in module.modules():
                if isinstance(m, lfm2.SparseMoe):
                    for w in (m.w13, m.w2):
                        w.copy_(fp8_rows_(w.float()))
        return module

    return _replaced(lfm2, "build", rounded)


FAULTS = {"no_causal_mask": no_causal_mask, "no_expert_bias": no_expert_bias,
          "conv_not_causal": conv_not_causal, "conv_without_b_gate": conv_without_b_gate,
          "fp8_experts": fp8_experts}


def main(argv=None) -> int:
    from portbench import calibrate, faults

    faults.FAULTS.update(FAULTS)
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
