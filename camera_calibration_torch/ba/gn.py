"""Generic matrix-free Levenberg-Marquardt with an inner CG solve.

The problem is a residual function of a state plus a retraction: the
normal equations (JᵀWJ + λI) δ = −JᵀWr are solved by unpreconditioned
conjugate gradients, with J·v and Jᵀ·u from ``torch.func.jvp`` and
``torch.func.vjp`` of ``δ ↦ residual(retract(state, δ))`` at δ = 0.  No
Jacobian is formed.  States and tangents are tensors or pytrees of tensors
(tuples, lists, dicts).

λ starts from the Gauss-Newton matvec of a ones-vector probe, is halved on
an accepted step and doubled on a rejected one.  The loops run on the host:
each LM iteration reads its accept decision and each CG iteration its stop
test.  This engine serves model fitting and refinement; the bundle
adjustment has its own solver (``ba/lm_pcg.py``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree


class LMResult(NamedTuple):
    state: Any
    cost: torch.Tensor
    iterations: int
    lam: torch.Tensor


def _dot(a, b):
    return sum(torch.dot(x.reshape(-1), y.reshape(-1))
               for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def _axpy(alpha, x, y):
    return pytree.tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def lm_solve(
    residual_fn: Callable[[Any], torch.Tensor],
    retract_fn: Callable[[Any, Any], Any],
    state0: Any,
    tangent_template: Any,
    *,
    max_iterations: int = 10,
    cg_iterations: int = 50,
    cg_tolerance: float = 1e-8,
    init_lambda_factor: float = 1e-3,
    lambda_min: float = 1e-12,
    weight_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    lam0=None,
):
    """Minimize 0.5·Σ w(r)·r² over a manifold state.

    ``residual_fn(state)`` gives a flat residual tensor whose invalid terms
    are zero; ``retract_fn(state, tangent)`` the moved state;
    ``tangent_template`` the tangent's structure (zeros).  ``weight_fn``:
    IRLS weights from the squared residuals, frozen within an iteration
    (the cost is then Σ 0.5·w·r²).  ``lam0``: the first λ (default: from
    the diagonal probe).  The loop stops after ``max_iterations``, on an
    accepted step that improves the cost by less than 1e-9 relative, or
    once a rejected step pushes λ past 1e8.
    """

    def cost_of(state):
        r = residual_fn(state)
        sq = r * r
        if weight_fn is None:
            return 0.5 * torch.sum(sq)
        return torch.sum(0.5 * weight_fn(sq) * sq)

    zeros = pytree.tree_map(torch.zeros_like, tangent_template)
    ones = pytree.tree_map(torch.ones_like, zeros)
    n_params = sum(x.numel() for x in pytree.tree_leaves(tangent_template))
    cost = cost_of(state0)
    lam = torch.as_tensor(-1.0 if lam0 is None else lam0, dtype=cost.dtype,
                          device=cost.device)
    state, it, done = state0, 0, False
    while it < max_iterations and not done:
        def f(tangent, state=state):
            return residual_fn(retract_fn(state, tangent))

        r, pullback = torch.func.vjp(f, zeros)
        w = torch.ones_like(r) if weight_fn is None else weight_fn(r * r)

        def gn_matvec(v):
            _, jv = torch.func.jvp(f, (zeros,), (v,))
            return pullback(w * jv)[0]

        grad = pullback(w * r)[0]  # JᵀWr
        if bool(lam < 0):
            lam = init_lambda_factor * torch.abs(_dot(ones, gn_matvec(ones))) \
                / max(n_params, 1)

        # CG on (JᵀWJ + λI) δ = −grad
        x = pytree.tree_map(torch.zeros_like, grad)
        rr = pytree.tree_map(torch.neg, grad)
        p = rr
        rs = _dot(rr, rr)
        k = 0
        while k < cg_iterations and bool(rs > cg_tolerance * cg_tolerance):
            ap = _axpy(lam, p, gn_matvec(p))
            alpha = rs / torch.clamp_min(_dot(p, ap), 1e-30)
            x = _axpy(alpha, p, x)
            rr = _axpy(-alpha, ap, rr)
            rs_new = _dot(rr, rr)
            p = _axpy(rs_new / torch.clamp_min(rs, 1e-30), p, rr)
            rs = rs_new
            k += 1

        test_state = retract_fn(state, x)
        test_cost = cost_of(test_state)
        accept = bool(test_cost < cost)
        # relative improvement against the cost before the step
        rel_impr = (cost - test_cost) / torch.clamp_min(cost, 1e-30)
        if accept:
            state, cost = test_state, test_cost
        lam = torch.clamp_min(0.5 * lam if accept else 2.0 * lam, lambda_min)
        done = (not accept and bool(lam > 1e8)) or (
            accept and bool(rel_impr < 1e-9))
        it += 1
    return LMResult(state=state, cost=cost, iterations=it, lam=lam)
