"""``repro_torch.autodiff.grad``, the gradient the port's training rules
take: outside a ``torch.func`` transform it is the plain autograd gradient,
whose backward keeps no graph (``torch.func.grad`` runs its backward with
``create_graph=True``); inside one (``vmap``, ``jvp``) it is
``torch.func.grad``.  Either way the gradient equals ``torch.func.grad``'s
bit for bit, on a tree with a ``None`` slot and an unused leaf."""
import torch
from torch.func import grad as func_grad
from torch.func import jvp, vmap

from repro_torch.autodiff import grad
from repro_torch.tree import tree_leaves

SEEN = []


class Probe(torch.autograd.Function):
    """Identity whose backward records whether it builds a graph."""

    @staticmethod
    def forward(x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        SEEN.append(torch.is_grad_enabled())
        return g

    @staticmethod
    def vmap(info, in_dims, x):
        return Probe.apply(x), in_dims[0]

    @staticmethod
    def jvp(ctx, t):
        return t


def _loss(p, x):
    h = torch.tanh(Probe.apply(x @ p["w"]) + p["b"])
    return (h * p["layers"][0]).square().sum()


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(5, 3, generator=g),
            "b": torch.randn(3, generator=g),
            "layers": [torch.randn(3, generator=g)],
            "unused": torch.randn(2, generator=g)}


def test_grad_equals_func_grad_and_keeps_no_graph():
    p, x = _tree(), torch.randn(4, 5)
    SEEN.clear()
    got = grad(_loss)(p, x)
    assert SEEN == [False]            # the backward ran without a graph
    want = func_grad(_loss)(p, x)
    assert SEEN == [False, True]      # torch.func.grad's builds one
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert not a.requires_grad
        assert torch.equal(a, b)
    assert torch.equal(got["unused"], torch.zeros(2))


def test_grad_composes_inside_transforms():
    p, xs = _tree(), torch.randn(3, 4, 5)
    got = vmap(grad(_loss), in_dims=(None, 0))(p, xs)
    want = vmap(func_grad(_loss), in_dims=(None, 0))(p, xs)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    # forward over reverse: Option B's exact Hessian-vector product
    t = {k: (torch.ones_like(v) if torch.is_tensor(v) else
             [torch.ones(3)]) for k, v in p.items()}
    got = jvp(lambda q: grad(_loss)(q, xs[0]), (p,), (t,))[1]
    want = jvp(lambda q: func_grad(_loss)(q, xs[0]), (p,), (t,))[1]
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
