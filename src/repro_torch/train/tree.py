"""Nested dicts of tensors (the port's params, optimizer and train state)
as trees: the few pytree operations the training modules need."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """fn applied leaf by leaf; `rest` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of `tree`'s structure holding `leaves` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_paths(tree, prefix: str = "") -> dict:
    """"a/b/c" path -> leaf, in insertion order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
