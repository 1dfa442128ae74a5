"""Huber loss on squared residual magnitudes (value + IRLS weight).

Costs carry the 1/2 factor inside the quadratic region; ``huber_weight``
is the IRLS multiplier applied to JᵀJ / Jᵀr rows.
"""

from __future__ import annotations

import torch


def huber_cost(sq_r, tau):
    tau_sq = tau * tau
    lin = tau * (torch.sqrt(torch.clamp_min(sq_r, tau_sq)) - 0.5 * tau)
    return torch.where(sq_r < tau_sq, 0.5 * sq_r, lin)


def huber_weight(sq_r, tau):
    tau_sq = tau * tau
    return torch.where(
        sq_r < tau_sq,
        torch.ones_like(sq_r),
        tau / torch.sqrt(torch.clamp_min(sq_r, tau_sq)),
    )
