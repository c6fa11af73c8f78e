"""The port's parameter trees as the reference's pytrees: leaves in
`jax.tree.flatten`'s order and structure-preserving maps.

A tree is a `ParamTree` (its parameters and submodules, by name), a dict,
a list (or `ModuleList`), a tuple, or a tensor leaf.  Dict-like nodes are
walked in sorted-key order, as `jax.tree.flatten` walks a dict, and lists
in order.  `map_tree` and `unflatten` rebuild the structure: a `ParamTree`
becomes a new `ParamTree` (frozen leaves), a dict a dict, a list a list.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.common import ParamTree


def _children(node) -> list:
    """(key, child) pairs of an inner node, in flatten order."""
    if isinstance(node, ParamTree):
        names = sorted([*node._parameters, *node._modules])
        return [(k, node[k]) for k in names]
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple, torch.nn.ModuleList)):
        return list(enumerate(node))
    raise TypeError(f"not a tree node: {type(node).__name__}")


def leaves(tree) -> list[torch.Tensor]:
    """Every tensor of the tree, in flatten order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for _, child in _children(tree) for leaf in leaves(child)]


def paths(tree, prefix: str = "") -> list[str]:
    """Every leaf's dotted path (`layers.3.attn.wq`), in flatten order."""
    if isinstance(tree, torch.Tensor):
        return [prefix]
    return [p for k, child in _children(tree)
            for p in paths(child, f"{prefix}.{k}" if prefix else str(k))]


def structure(tree) -> str:
    """A printable description of the tree's structure (the manifest's
    `treedef`)."""
    if isinstance(tree, torch.Tensor):
        return "*"
    inner = ", ".join(f"{k!r}: {structure(c)}" for k, c in _children(tree))
    if isinstance(tree, (list, tuple, torch.nn.ModuleList)):
        return f"[{inner}]"
    return f"{{{inner}}}"


def unflatten(like, new_leaves) -> object:
    """A tree of `like`'s structure holding `new_leaves` (flatten order)."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        kids = {k: build(c) for k, c in _children(node)}
        if isinstance(node, (list, tuple, torch.nn.ModuleList)):
            return [kids[i] for i in range(len(kids))]
        return kids

    def wrap(node, built):
        # the outermost ParamTrees are rebuilt from their dicts (inside one,
        # dicts and lists become its submodules)
        if isinstance(node, ParamTree):
            return ParamTree(built)
        if isinstance(node, torch.Tensor):
            return built
        return type(built)(wrap(c, built[k]) for k, c in _children(node)) \
            if isinstance(built, list) else {k: wrap(c, built[k]) for k, c in _children(node)}

    out = wrap(like, build(like))
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn: Callable, tree, *others):
    """`fn` applied leaf by leaf to `tree` and trees of its structure."""
    columns = [leaves(tree)] + [leaves(o) for o in others]
    if any(len(c) != len(columns[0]) for c in columns):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*columns)])
