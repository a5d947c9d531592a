"""Nested dicts of tensors (params, optimizer state, a train state) in
JAX's leaf order: `jax.tree` flattens a dict by its sorted keys, so every
function here walks keys sorted.  The order fixes the f32 sum of the
global norm and the key order of a checkpoint file."""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Tuple

import torch

Tree = Any
SEP = "/"


def items(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in JAX's order; a path joins the keys with "/", as
    `repro.training.checkpoint` names its leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}{k}{SEP}")
    else:
        yield prefix[:-len(SEP)], tree


def leaves(tree: Tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in items(tree)]


def unflatten(like: Tree, values: Iterable) -> Tree:
    """The structure of `like` with `values` as its leaves, in JAX's
    order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


def map_tree(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (the same structure)."""
    return unflatten(tree, (fn(*ls) for ls in zip(
        leaves(tree), *(leaves(r) for r in rest), strict=True)))
