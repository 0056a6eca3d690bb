"""Adam with a first moment in another dtype: optax's ``adam(lr, b1, b2,
eps, eps_root=0, mu_dtype)`` step by step, as a ``torch.optim.Optimizer``
(the JAX trainer's ``TrainerConfig.adam_mu_dtype``). ``torch.optim.Adam``
keeps both moments in the parameter's dtype.

One step on a parameter p with gradient g (optax's ``scale_by_adam`` then
``scale_by_learning_rate``; t counts the updates, incremented first):

  mu  = (1 - b1) * g + b1 * m      b1 * m in m's dtype (a bf16 product,
                                   as flax's weak-typed 0.9 * m), the sum fp32
  nu  = (1 - b2) * g**2 + b2 * v   fp32
  p  += -lr * (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
  m   = mu cast to m's dtype (round to nearest even); v = nu

The update is computed from the fp32 ``mu`` before it is rounded for
storage. With ``mu_dtype=None`` the first moment is fp32 and the step
agrees with ``torch.optim.Adam`` to rounding: torch folds the bias
corrections into one step size in double precision and updates m by
``lerp_``. Parameters without a gradient are skipped, as
``torch.optim.Adam`` skips them.

``capturable=True`` keeps the step count on the parameter's device (an
fp32 0-dim tensor, as ``torch.optim.Adam(capturable=True)`` keeps it) and
computes the bias corrections there, in fp32 (optax's arithmetic), so the
step reads nothing from the host and a CUDA graph can hold it; the
learning rate may then be a 0-dim tensor on that device, filled in place.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["Adam", "mu_dtype_of"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def mu_dtype_of(mu_dtype) -> Optional[torch.dtype]:
    """A ``torch.dtype`` (or None) from a dtype name or a ``torch.dtype``."""
    if mu_dtype is None or isinstance(mu_dtype, torch.dtype):
        return mu_dtype
    if str(mu_dtype) not in _DTYPES:
        raise ValueError(f"adam mu_dtype must be one of {sorted(_DTYPES)} or None; got {mu_dtype!r}")
    return _DTYPES[str(mu_dtype)]


class Adam(torch.optim.Optimizer):
    """optax's Adam with ``mu_dtype`` (module docstring). State per
    parameter: ``step`` (an int; with ``capturable``, an fp32 0-dim tensor
    on the parameter's device), ``exp_avg`` (in ``mu_dtype``, else the
    parameter's dtype) and ``exp_avg_sq`` (the parameter's dtype)."""

    def __init__(self, params, lr=1e-4, betas: tuple = (0.9, 0.999),
                 eps: float = 1e-8, mu_dtype=None, capturable: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, capturable=capturable))
        self.mu_dtype = mu_dtype_of(mu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = (torch.zeros((), dtype=torch.float32, device=p.device)
                                     if group["capturable"] else 0)
                    state["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                if group["capturable"]:  # fp32 on the device: optax's 1 - b ** count
                    t = state["step"].add_(1)
                    bc1 = 1.0 - torch.full_like(t, b1).pow_(t)
                    bc2 = 1.0 - torch.full_like(t, b2).pow_(t)
                else:
                    state["step"] += 1
                    t = np.float32(state["step"])
                    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
                    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
                # b1 * m rounds in m's dtype: a Python scalar would multiply in fp32 first
                mu = g.mul(1.0 - b1).add_(m * torch.tensor(b1, dtype=m.dtype))
                v.mul_(b2).add_(g.square().mul_(1.0 - b2))
                denom = v.div(bc2).sqrt_().add_(eps)
                p.add_(mu.div(bc1).div_(denom).mul_(-lr))
                m.copy_(mu)

    def load_state_dict(self, state_dict: dict) -> None:
        # the base class casts floating state to the parameter's dtype;
        # put the first moment back in its own (exact: it was stored there),
        # and the step count in this optimizer's form (it counts whole steps)
        capturable = [g["capturable"] for g in self.param_groups]
        super().load_state_dict(state_dict)
        for group, cap in zip(self.param_groups, capturable):
            group["capturable"] = cap
            for p in group["params"]:
                state = self.state.get(p)
                if not state:
                    continue
                step = state["step"]
                state["step"] = (torch.as_tensor(step, dtype=torch.float32).to(p.device).clone()
                                 if cap else int(step))
                if self.mu_dtype is not None:
                    state["exp_avg"] = state["exp_avg"].to(self.mu_dtype)
