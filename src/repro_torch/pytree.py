"""Nested containers of tensors, flattened in the JAX package's order.

`jax.tree.flatten` visits a dict's entries in sorted-key order and a list
or tuple's in order, and treats None as an empty node.  The optimizer
states, the train state and the checkpoint files follow that order here,
so a leaf's index in a checkpoint is the one the JAX manager gives it
(`torch.utils._pytree` keeps a dict's insertion order instead).
"""

from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves of `tree`, dict entries in sorted-key order."""
    out: List[Any] = []

    def walk(t):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            out.append(t)

    walk(tree)
    return out


def unflatten(like, values) -> Any:
    """A tree of `like`'s structure holding `values` in leaf order."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest` (trees
    of the same structure)."""
    flat = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError(f"trees of different sizes: {[len(f) for f in flat]}")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def describe(tree) -> str:
    """The structure of `tree` as text, `*` for a leaf (for tree.json)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(describe(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"

