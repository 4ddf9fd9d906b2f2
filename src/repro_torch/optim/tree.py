"""The trees the optimizer walks: parameters and state as named tensors.

A tree is an ``nn.Module`` (its parameters), a dict of trees, or a tensor.
:func:`named_leaves` flattens it to ``{name: tensor}`` in a fixed order
(``named_parameters()`` order for a module, ``a.b`` keys for nested dicts);
optimizer and sync state are flat dicts keyed by those names.
:func:`map_tree` rebuilds a tree with every tensor replaced, and
:func:`map_named` with every tensor replaced by a function of its name.
"""

from __future__ import annotations

import copy
from typing import Any, Callable

import torch
from torch import nn

__all__ = ["named_leaves", "map_tree", "map_named"]


def named_leaves(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    if isinstance(tree, nn.Module):
        return {prefix + n: p for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        out: dict[str, torch.Tensor] = {}
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def map_tree(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any, *,
             requires_grad: bool | None = None) -> Any:
    """``tree`` with every tensor ``x`` replaced by ``fn(x)``. A module is
    copied with new parameters (``requires_grad`` as given, else as the
    old), sharing no storage with the old unless ``fn`` returns views."""
    if isinstance(tree, nn.Module):
        memo = {}
        for p in tree.parameters():
            rg = p.requires_grad if requires_grad is None else requires_grad
            memo[id(p)] = nn.Parameter(fn(p.detach()), requires_grad=rg)
        return copy.deepcopy(tree, memo)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, requires_grad=requires_grad) for k, v in tree.items()}
    return fn(tree)


def map_named(fn: Callable[[str, torch.Tensor], torch.Tensor], tree: Any, *,
              requires_grad: bool | None = None) -> Any:
    """:func:`map_tree` with ``fn(name, x)``, ``name`` the leaf's key in
    :func:`named_leaves`."""
    names = iter(named_leaves(tree))  # map_tree visits the leaves in this order
    return map_tree(lambda x: fn(next(names), x), tree, requires_grad=requires_grad)
