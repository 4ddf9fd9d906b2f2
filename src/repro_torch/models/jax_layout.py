"""The JAX package's parameter trees and the port's parameter modules.

The JAX models keep their weights in nested dicts whose per-layer leaves are
stacked along a leading layer axis (a ``lax.scan`` reads them so). The port
keeps one module per layer: a parameter ``layers.3.attn.q.w`` is row 3 of the
JAX leaf ``layers/.../attn/q/w``. A model names its stacks by a mapping from
the prefix of its layer list (``"layers"``, ``"lm.layers"``,
``"enc_layers"``) to the size of its groups:

* ``None``: the JAX leaf is ``prefix/rest``, stacked over the layers;
* ``G`` (the transformer's group, 1 for a dense one): layer ``i`` is
  sub-layer ``i % G`` of group ``i // G``, the JAX leaf
  ``prefix/sub_{i % G}/rest``, stacked over the groups.

:func:`stack` and :func:`unstack` map tensors keyed by parameter name (the
parameters, or anything keyed by their names, such as optimizer moments) to
the tree and back; :func:`from_numpy` / :func:`to_numpy` carry a tree of
numpy arrays into a model's parameter module and out.

Each model names its stacks in one place, its ``stacks`` attribute, and
takes :class:`Stacked`'s methods, which read it: ``params_from_numpy`` /
``params_to_numpy`` (weights across packages) and ``to_jax_layout`` /
``from_jax_layout`` (anything keyed by parameter name, such as gradients,
optimizer moments and the training CLI's checkpoints).

Sharding specs keep the JAX layout too. A ``PartitionSpec`` is written as
the tuple of its entries (:func:`P`; ``tuple(P(...))`` in JAX gives the same
value), a model's ``param_pspecs`` is a tree of them keyed like its JAX
parameters, and :meth:`Stacked.named_pspecs` gives each of the port's
per-layer leaves its stacked spec without the stack's axis.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["P", "stacked", "stack", "unstack", "from_numpy", "to_numpy", "Stacked"]

Stacks = Mapping[str, "int | None"]


def P(*entries) -> tuple:
    """A JAX ``PartitionSpec`` as the tuple of its entries: ``None``, an
    axis name, or a tuple of names, one entry a leading dimension. A tuple
    of one name becomes the name, as JAX normalises it."""
    def entry(e):
        if isinstance(e, (tuple, list)):
            return e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(entry(e) for e in entries)


def stacked(specs):
    """Every spec of a tree (nested dicts of :func:`P` tuples) with a
    leading ``None``: the specs of leaves stacked over the layers."""
    if isinstance(specs, Mapping):
        return {k: stacked(v) for k, v in specs.items()}
    return (None, *specs)


def _split(name: str, stacks: Stacks):
    """``(prefix, layer index, rest)`` for a name inside a stack, else None."""
    for prefix in stacks:
        head = prefix + "."
        if name.startswith(head):
            idx, _, rest = name[len(head):].partition(".")
            return prefix, int(idx), rest
    return None


def _set(tree: dict, path: tuple[str, ...], x) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = x


def stack(named: Mapping[str, Any], stacks: Stacks, lead: int = 0) -> dict:
    """Tensors keyed by parameter name as the JAX tree: nested dicts, each
    layer leaf stacked over its stack's layers (or groups) at axis ``lead``
    (0, or 1 after the hierarchical trainer's pod axis)."""
    tree: dict = {}
    rows: dict[tuple[str, ...], dict[int, Any]] = {}
    for name, x in named.items():
        hit = _split(name, stacks)
        if hit is None:
            _set(tree, tuple(name.split(".")), x)
            continue
        prefix, i, rest = hit
        g = stacks[prefix]
        path = tuple(prefix.split(".")) + (() if g is None else (f"sub_{i % g}",))
        rows.setdefault(path + tuple(rest.split(".")), {})[i if g is None else i // g] = x
    for path, by_row in rows.items():
        _set(tree, path, torch.stack([by_row[i] for i in sorted(by_row)], dim=lead))
    return tree


def unstack(tree: Mapping, stacks: Stacks, lead: int = 0) -> dict[str, Any]:
    """The inverse of :func:`stack`: tensors keyed by parameter name, the
    layer leaves unstacked (views) along axis ``lead``."""
    def leaves(node, path):
        if not isinstance(node, Mapping):
            yield path, node
            return
        for k, v in node.items():
            yield from leaves(v, path + (k,))

    out: dict[str, Any] = {}
    for path, x in leaves(tree, ()):
        for prefix, g in stacks.items():
            head = tuple(prefix.split("."))
            if path[:len(head)] != head:
                continue
            rest = path[len(head) + (g is not None):]
            sub = 0 if g is None else int(path[len(head)].removeprefix("sub_"))
            for r, row in enumerate(torch.unbind(x, dim=lead)):
                layer = r if g is None else r * g + sub
                out[".".join((prefix, str(layer)) + rest)] = row
            break
        else:
            out[".".join(path)] = x
    return out


def _tensor(x, device) -> torch.Tensor:
    a = np.array(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch reads no such numpy dtype
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def from_numpy(skeleton: nn.Module, tree: Mapping, stacks: Stacks, device=None) -> nn.Module:
    """A JAX parameter tree of numpy arrays loaded into ``skeleton`` (a
    model's parameters on the ``meta`` device): names and shapes checked by
    ``load_state_dict(assign=True)``, frozen as made."""
    def walk(node):
        return ({k: walk(v) for k, v in node.items()} if isinstance(node, Mapping)
                else _tensor(node, device))

    named = unstack(walk(tree), stacks)
    skeleton.load_state_dict({n: x.clone() for n, x in named.items()}, assign=True)
    return skeleton


def to_numpy(params: nn.Module, stacks: Stacks) -> dict:
    """The inverse of :func:`from_numpy`: the parameters as the JAX tree of
    numpy arrays. numpy has no bfloat16, so a bf16 leaf comes back as its
    exact float32 widening."""
    def host(p: torch.Tensor) -> torch.Tensor:
        x = p.detach().cpu()
        return x.float() if x.dtype == torch.bfloat16 else x

    def to_np(node):
        return {k: to_np(v) for k, v in node.items()} if isinstance(node, dict) else node.numpy()

    return to_np(stack({n: host(p) for n, p in params.named_parameters()}, stacks))


class Stacked:
    """The JAX layout of a model's parameters, read from its ``stacks``
    (the prefix of each layer list and its group size, as above) and
    ``init_params(None, device="meta")`` (the skeleton)."""

    stacks: Stacks

    def to_jax_layout(self, named: Mapping[str, Any], lead: int = 0) -> dict:
        """Tensors keyed by parameter name as the JAX tree, the layer leaves
        stacked at axis ``lead`` (0, or 1 after the hierarchical trainer's
        pod axis)."""
        return stack(named, self.stacks, lead)

    def from_jax_layout(self, tree: Mapping, lead: int = 0) -> dict[str, Any]:
        """The inverse of :meth:`to_jax_layout` (the layer leaves unstacked
        as views)."""
        return unstack(tree, self.stacks, lead)

    def named_pspecs(self, specs: Mapping, lead: int = 0) -> dict[str, tuple]:
        """A spec tree in the JAX layout (``param_pspecs``, or one with the
        hierarchical trainer's pod axis in front, ``lead`` 1) as each of the
        port's parameter names' spec: a layer leaf's spec without the entry
        at ``lead``, its stack's axis."""
        out = {}
        for name, _ in self.init_params(None, device="meta").named_parameters():
            hit = _split(name, self.stacks)
            if hit is None:
                path = name.split(".")
            else:
                prefix, i, rest = hit
                g = self.stacks[prefix]
                path = prefix.split(".") + ([] if g is None else [f"sub_{i % g}"]) + rest.split(".")
            spec = specs
            for part in path:
                spec = spec[part]
            if hit is not None:
                if len(spec) <= lead or spec[lead] is not None:
                    raise ValueError(f"{name}: the stacked spec {spec} has no free stack axis "
                                     f"at {lead}")
                spec = spec[:lead] + spec[lead + 1:]
            out[name] = spec
        return out

    def params_from_numpy(self, tree: Mapping, device=None) -> nn.Module:
        """The JAX parameter tree (numpy arrays) as the port's parameters,
        frozen as made."""
        return from_numpy(self.init_params(None, device="meta"), tree, self.stacks, device)

    def params_to_numpy(self, params: nn.Module) -> dict:
        """The inverse of :meth:`params_from_numpy`; a bf16 leaf comes back
        as its exact float32 widening."""
        return to_numpy(params, self.stacks)
