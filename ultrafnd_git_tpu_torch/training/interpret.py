"""Attributions of the classifier's input (counterpart of
`ultrafnd_git_tpu/training/interpret.py`): Gradient x Input, SmoothGrad and
KernelSHAP over the fused embedding plus the aux scalars.

* `feature_importance`: |d logits[:, class_idx] / d x * x| per row, by
  `torch.autograd.grad` (run with autograd on, also when the caller is
  under `torch.inference_mode`).
* `smooth_grad`: mean |d probs[:, 1] / d x| over Gaussian draws at
  x + noise_i, sigma = 0.1 of each feature's std (the noise from a seeded
  `torch.Generator`; the JAX draws cannot be repeated).
* `explain_shap`: the native KernelSHAP (`ops/kernel_shap.py`) of the
  class-1 probability in fixed row chunks, or SmoothGrad magnitudes if it
  fails. The JAX ladder's first rung, the optional `shap` package, is left
  out (neither machine the port runs on has it); `"method"` names the rung
  that ran: "kernel-shap" or "smooth-grad".

`model` is the port's `DeepTruthClassifier` (eval mode: dropout off) and
carries its own parameters; inputs are numpy or tensors, results numpy.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier
from ultrafnd_git_tpu_torch.ops.kernel_shap import kernel_shap


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _inputs(model, fused, aux) -> Tuple[torch.Tensor, int]:
    """(x = [fused, aux] f32 on the model's device, fused width)."""
    dev = _device(model)
    f = torch.as_tensor(np.asarray(fused, np.float32), device=dev)
    if aux is None or not model.use_aux:
        return f, f.shape[-1]
    a = torch.as_tensor(np.asarray(aux, np.float32), device=dev)
    return torch.cat([f, a], dim=-1), f.shape[-1]


def _forward(model: DeepTruthClassifier, x: torch.Tensor, fused_dim: int):
    aux = x[:, fused_dim:] if x.shape[-1] > fused_dim else None
    return model(x[:, :fused_dim], aux)


def feature_importance(
    model: DeepTruthClassifier,
    fused,
    aux=None,
    class_idx: int = 1,
    aggregate: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Gradient x Input on the class-`class_idx` logit: (B, F[+A]) and its
    mean over rows (or None)."""
    with torch.inference_mode(False), torch.enable_grad():
        x, fused_dim = _inputs(model, fused, aux)
        x = x.clone().requires_grad_(True)
        logits = _forward(model, x, fused_dim)["logits"]
        (grad,) = torch.autograd.grad(logits[:, class_idx].sum(), x)
        imp = (grad * x).abs().detach().cpu().numpy()
    return (imp, imp.mean(axis=0)) if aggregate else (imp, None)


def smooth_grad(
    model: DeepTruthClassifier,
    fused,
    aux=None,
    n_samples: int = 16,
    sigma_scale: float = 0.1,
    seed: int = 0,
) -> np.ndarray:
    """Mean |d probs[:, 1] / d x| over `n_samples` Gaussian perturbations."""
    with torch.inference_mode(False), torch.enable_grad():
        x, fused_dim = _inputs(model, fused, aux)
        sigma = sigma_scale * x.std(dim=0, keepdim=True, correction=0).clamp_min(1e-6)
        gen = torch.Generator().manual_seed(int(seed))
        total = torch.zeros_like(x)
        for _ in range(n_samples):
            noise = torch.randn(x.shape, generator=gen).to(x.device) * sigma
            xn = (x + noise).requires_grad_(True)
            probs = _forward(model, xn, fused_dim)["probs"]
            (grad,) = torch.autograd.grad(probs[:, 1].sum(), xn)
            total += grad.abs()
        return (total / n_samples).cpu().numpy()


def explain_shap(
    model: DeepTruthClassifier,
    fused,
    aux=None,
    max_samples: int = 256,
    seed: int = 0,
    n_coalitions: Optional[int] = None,
    background_size: int = 32,
    background: Optional[np.ndarray] = None,
    row_chunk: int = 16,
) -> Dict[str, Any]:
    """SHAP values of the class-1 probability: {"method": "kernel-shap",
    "values" (B, F[+A]), "base_values" (B,)}, or {"method": "smooth-grad",
    "values"} when KernelSHAP fails (SmoothGrad magnitudes carry no
    additivity). `background` (K, F[+A]) defaults to the first
    `background_size` explained rows; explained rows go through KernelSHAP
    `row_chunk` at a time, the last chunk padded by repeating its last row.
    """
    fused = np.asarray(fused, np.float32)[:max_samples]
    aux_np = None if aux is None else np.asarray(aux, np.float32)[:max_samples]
    x, fused_dim = _inputs(model, fused, aux_np)
    bg = (torch.as_tensor(np.asarray(background, np.float32), device=x.device)
          if background is not None else x[:background_size])
    try:
        with torch.inference_mode():
            def prob1(xb):
                return _forward(model, xb, fused_dim)["probs"][:, 1]

            step = max(1, int(row_chunk))
            phis, bases = [], []
            for s in range(0, x.shape[0], step):
                xc = x[s:s + step]
                keep = xc.shape[0]
                if keep < step:
                    xc = torch.cat([xc, xc[-1:].expand(step - keep, -1)])
                phi, base = kernel_shap(prob1, xc, bg, n_coalitions=n_coalitions,
                                        chunk=128, seed=seed)
                phis.append(phi[:keep])
                bases.append(base[:keep])
            return {
                "method": "kernel-shap",
                "values": torch.cat(phis).cpu().numpy(),
                "base_values": torch.cat(bases).cpu().numpy(),
            }
    except Exception as exc:  # noqa: BLE001 - the ladder's last rung, logged
        warnings.warn(f"native KernelSHAP failed ({exc!r}); returning SmoothGrad "
                      "magnitudes (unsigned, no additivity guarantee)")
        return {"method": "smooth-grad",
                "values": smooth_grad(model, fused, aux_np, seed=seed)}
