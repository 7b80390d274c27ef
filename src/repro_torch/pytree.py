"""Nested containers of tensors, flattened in the JAX package's order.

`jax.tree.flatten` visits a dict's entries in sorted-key order and a list
or tuple's in order, and treats None as an empty node.  The optimizer
states, the train state and the checkpoint files follow that order here,
so a leaf's index in a checkpoint is the one the JAX manager gives it
(`torch.utils._pytree` keeps a dict's insertion order instead).

The walks recurse through module-level functions: a nested function that
calls itself is a reference cycle (function -> closure cell -> function)
that keeps what it closes over, every leaf of a train state or a step's
gradients, alive until the cyclic garbage collector runs.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


def leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    """The leaves of `tree`, dict entries in sorted-key order; a node for
    which is_leaf is true is a leaf (a tree of logical-axes tuples)."""
    out: List[Any] = []
    _collect(tree, out, is_leaf)
    return out


def _collect(t, out: List[Any], is_leaf) -> None:
    if t is None:
        return
    if is_leaf is not None and is_leaf(t):
        out.append(t)
    elif isinstance(t, dict):
        for k in sorted(t):
            _collect(t[k], out, is_leaf)
    elif isinstance(t, (list, tuple)):
        for v in t:
            _collect(v, out, is_leaf)
    else:
        out.append(t)


def unflatten(like, values, is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """A tree of `like`'s structure holding `values` in leaf order."""
    it = iter(values)
    out = _build(like, it, is_leaf)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def _build(t, it, is_leaf) -> Any:
    if t is None:
        return None
    if is_leaf is not None and is_leaf(t):
        return next(it)
    if isinstance(t, dict):
        return {k: _build(t[k], it, is_leaf) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it, is_leaf) for v in t)
    return next(it)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest` (trees
    of the same structure)."""
    flat = [leaves(tree, is_leaf)] + [leaves(r, is_leaf) for r in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError(f"trees of different sizes: {[len(f) for f in flat]}")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)], is_leaf)


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

