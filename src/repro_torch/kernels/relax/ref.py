"""Plain PyTorch version of the `relax` kernels: the loop of the
reference's ``relaxed_cost`` (`src/repro/policies/tune.py:104-122`) in
torch, one interval a Python iteration. Autograd through it gives the
gradient, the plain version of the reverse kernel.

``consts`` is ``(interval_s, spin_up_s, S, I_f, B_f, miss_weight,
sharp)``, the fields of `repro_torch.policies.tune.RelaxSpec` after
``demand``. The sum is ``torch.sum`` of the stacked interval costs, after
the loop, as the reference sums after its scan.
"""

from __future__ import annotations

import torch


def softplus(x: torch.Tensor, sharp: float) -> torch.Tensor:
    """softplus(x * sharp) / sharp, exact at every x: torch's own
    ``softplus`` turns linear above its threshold of 20, the reference's
    does not."""
    y = x * sharp
    return torch.logaddexp(y, torch.zeros_like(y)) / sharp


def relax_loop(theta: torch.Tensor, demand: torch.Tensor, consts):
    """The relaxation's cost and, per interval, what the reverse kernel
    needs: (cost (), n (K,) before each step, delta (K,), w (K,)), in
    theta's type. Differentiable in ``theta`` under autograd."""
    interval_s, spin_up_s, S, I_f, B_f, miss_weight, sharp = consts
    headroom, gain, util = theta[0], theta[1], theta[2]
    one = torch.ones((), dtype=theta.dtype, device=theta.device)
    interval = interval_s * one
    lam = demand.to(theta.dtype) / (S * interval)          # FPGA units
    alpha_up = interval / (interval + spin_up_s)
    n, lam_prev = lam[0] + headroom, lam[0]
    costs, ns, deltas, ws = [], [], [], []
    for k in range(lam.shape[0]):
        lam_k = lam[k]
        lam_hat = lam_k + gain * (lam_k - lam_prev)
        target = lam_hat / util + headroom
        delta = target - n
        w_up = torch.sigmoid(sharp * delta)
        n_new = n + (w_up * alpha_up + (1.0 - w_up)) * delta
        idle_j = I_f * interval * softplus(n_new - lam_k, sharp)
        spin_j = B_f * spin_up_s * softplus(delta, sharp)
        short = softplus(lam_k - n_new, sharp)             # FPGA units short
        costs.append(idle_j + spin_j + miss_weight * short * S * interval)
        ns.append(n)
        deltas.append(delta)
        ws.append(w_up)
        n, lam_prev = n_new, lam_k
    return (torch.stack(costs).sum(), torch.stack(ns), torch.stack(deltas),
            torch.stack(ws))


def relaxed_cost_ref(theta: torch.Tensor, demand: torch.Tensor,
                     consts) -> torch.Tensor:
    """The relaxation's cost, a 0-dim tensor in theta's type."""
    return relax_loop(theta, demand, consts)[0]


def relax_grad_ref(theta: torch.Tensor, demand: torch.Tensor, consts,
                   grad_out: torch.Tensor | float = 1.0) -> torch.Tensor:
    """grad_out * dcost/dtheta (3,) by autograd through the loop."""
    th = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        cost = relaxed_cost_ref(th, demand, consts)
        g, = torch.autograd.grad(cost, th)
    return g * grad_out
