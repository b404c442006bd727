"""Option C — Moreau-envelope personalization (paper Eq. 6–8, 10), as in
``src/repro/core/moreau.py``.

F_i(w) = min_θ [ f_i(θ) + λ/2 ‖θ − w‖² ]         (Moreau envelope)
∇F_i(w) = λ (w − θ̂_i(w))                          (Eq. 7, Appendix C)

θ̂ is approximated by θ̃: K steps of SGD on the λ-regularized stochastic
loss h̃ (Algorithm 2 step 11), giving the inexactness level ν = ‖∇h̃(θ̃)‖,
which is measured and returned.  The reference's ``lax.scan`` over the K
steps is a Python loop here.
"""
from __future__ import annotations

from typing import Callable, Tuple

from repro_torch.autodiff import grad
from repro_torch.core.maml import _axpy, tree_norm
from repro_torch.tree import tree_map

Loss = Callable


def prox_inner_grad(loss_fn: Loss, theta, w, batch, lam: float):
    """∇_θ h̃(θ, w; D) = ∇f̃(θ; D) + λ(θ − w)."""
    g = grad(loss_fn)(theta, batch)
    return tree_map(lambda gg, th, ww: gg + lam * (th - ww).to(gg.dtype),
                    g, theta, w)


def solve_prox(loss_fn: Loss, w, batch, lam: float, inner_eta: float,
               inner_steps: int) -> Tuple:
    """Inexactly minimize h̃(θ, w; D) from θ₀ = w.

    Returns (θ̃, ν_achieved) where ν = ‖∇h̃(θ̃)‖ (Algorithm 2 step 11).
    """
    theta = w
    for _ in range(inner_steps):
        theta = _axpy(-inner_eta,
                      prox_inner_grad(loss_fn, theta, w, batch, lam), theta)
    nu = tree_norm(prox_inner_grad(loss_fn, theta, w, batch, lam))
    return theta, nu


def me_grad(loss_fn: Loss, params, batch, lam: float, inner_eta: float,
            inner_steps: int):
    """Stochastic ME gradient ∇F̃_i(w; D) = λ(w − θ̃(w))  (Eq. 10).

    Returns (grad tree, ν achieved).
    """
    theta, nu = solve_prox(loss_fn, params, batch, lam, inner_eta,
                           inner_steps)
    g = tree_map(lambda ww, th: (lam * (ww - th)).to(ww.dtype), params, theta)
    return g, nu


def personalize_me(loss_fn: Loss, params, batch, lam: float,
                   inner_eta: float, inner_steps: int):
    """Client-side personalization: return θ̃_i(w), the personalized model
    the ME formulation serves."""
    theta, _ = solve_prox(loss_fn, params, batch, lam, inner_eta,
                          inner_steps)
    return theta
