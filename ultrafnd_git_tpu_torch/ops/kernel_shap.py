"""KernelSHAP: coalition sampling and the Shapley-kernel regression
(counterpart of `ultrafnd_git_tpu/ops/kernel_shap.py`).

For a model f, explained rows x and a background set B:

  1. draw M coalitions z in {0,1}^F with P(z) proportional to the Shapley
     kernel w(|z|) = (F-1) / (C(F,|z|) |z| (F-|z|)): a size s from
     p(s) ~ 1/(s (F-s)), then a uniform subset of that size, so that an
     unweighted least squares over the draws estimates the kernel-weighted
     one; each draw comes with its complement 1 - z (antithetic pairs);
  2. evaluate y(z) = mean_b f(z x + (1-z) B_b) over the background, in
     fixed chunks of coalitions (one batched forward per chunk);
  3. solve min sum_z (y(z) - phi0 - z . phi)^2 with phi0 = base = mean_b
     f(B_b) and phi0 + sum(phi) = f(x), by eliminating the last feature's
     coefficient: the efficiency axiom holds to float rounding by
     construction.

The coalitions come from an explicit `torch.Generator` (a CPU one, so a
seed gives the same design on any device); the port cannot repeat
`jax.random`'s draws, so its tests hold the solver and the axioms. The
solve is the minimum-norm least squares through the pseudo-inverse (an
SVD, `torch.linalg.pinv`, singular values below max(M, F) eps of the
largest dropped, as `jnp.linalg.lstsq`), one factorisation shared by every
explained row; it handles M < F, where the normal equations are singular.
`torch.linalg.lstsq` is not used: on CUDA it solves only by `gels`, which
assumes full rank.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def sample_coalitions(gen: torch.Generator, n_features: int, n_coalitions: int) -> torch.Tensor:
    """(M, F) 0/1 f32 coalitions (on the generator's device), M =
    n_coalitions rounded up to even: draws, then their complements."""
    if n_features < 2:
        raise ValueError("kernel SHAP needs >= 2 features")
    half = max(1, (n_coalitions + 1) // 2)
    dev = gen.device
    sizes = torch.arange(1, n_features, device=dev, dtype=torch.float64)
    p = 1.0 / (sizes * (n_features - sizes))
    s = 1 + torch.multinomial(p, half, replacement=True, generator=gen)
    u = torch.rand((half, n_features), generator=gen, device=dev)
    ranks = u.argsort(dim=1).argsort(dim=1)  # the s smallest become members
    z = (ranks < s[:, None]).to(torch.float32)
    return torch.cat([z, 1.0 - z])


def solve_kernel_shap(
    y: torch.Tensor, coalitions: torch.Tensor, fx: torch.Tensor, base: torch.Tensor
) -> torch.Tensor:
    """Constrained least squares shared by the explained rows.

    y (R, M) coalition values per row, coalitions (M, F), fx (R,) full-model
    outputs, base () mean background output -> phi (R, F) with
    base + phi.sum(-1) == fx.
    """
    a = coalitions[:, :-1] - coalitions[:, -1:]  # (M, F-1)
    adj = y - base - coalitions[None, :, -1] * (fx - base)[:, None]
    head = (torch.linalg.pinv(a) @ adj.T).T  # (R, F-1), minimum norm
    last = (fx - base) - head.sum(dim=1)
    return torch.cat([head, last[:, None]], dim=1)


def kernel_shap(
    f: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    background: torch.Tensor,
    n_coalitions: Optional[int] = None,
    chunk: int = 256,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SHAP values of `f` ((N, F) -> (N,)) at rows x (R, F) against
    background (K, F): (phi (R, F), base (R,)), with base + phi.sum(-1) ==
    f(x) per row. Costs about R M K forwards of f, `chunk` coalitions at a
    time. `n_coalitions` defaults to shap's auto budget, min(2F + 2048, 4096).
    """
    if x.dim() != 2 or background.dim() != 2:
        raise ValueError("x and background must be (rows, features)")
    x = x.to(torch.float32)
    background = background.to(torch.float32)
    rows, n_feat = x.shape
    n_bg = background.shape[0]
    if n_coalitions is None:
        n_coalitions = min(2 * n_feat + 2048, 4096)
    chunk = max(1, min(int(chunk), int(n_coalitions)))
    z = sample_coalitions(torch.Generator().manual_seed(int(seed)), n_feat,
                          int(n_coalitions)).to(x.device)
    parts = []
    for s in range(0, z.shape[0], chunk):
        zc = z[s:s + chunk]
        # (rows, chunk, n_bg, F): x where the coalition holds, background elsewhere
        mixed = zc[None, :, None] * x[:, None, None] + (1.0 - zc)[None, :, None] * background
        out = f(mixed.reshape(-1, n_feat)).reshape(rows, zc.shape[0], n_bg)
        parts.append(out.mean(dim=2))
    y = torch.cat(parts, dim=1)
    fx = f(x)
    base = f(background).mean()
    return solve_kernel_shap(y, z, fx, base), base.expand(rows)
