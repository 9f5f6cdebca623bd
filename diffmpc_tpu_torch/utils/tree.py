"""Nested dict / list / tuple containers of tensors (the JAX package's
pytrees), flattened and mapped as ``jax.tree_util`` does: dicts in sorted
key order."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, dicts in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with every leaf ``x`` replaced by ``fn(x)``, called in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        mapped = [tree_map(fn, v) for v in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    return fn(tree)


def prefix_leaves(prefix, tree, name: str) -> list:
    """For each leaf of ``tree`` (in :func:`tree_leaves` order), the leaf of
    ``prefix`` that governs it: ``prefix`` is a pytree prefix of ``tree``
    (``vmap``'s ``in_axes`` style), so a leaf of ``prefix`` (an int or None)
    stands for the whole subtree below it. A structure that is not a prefix
    raises ``ValueError`` naming ``name``."""
    if isinstance(prefix, dict):
        if not isinstance(tree, dict) or set(prefix) != set(tree):
            raise ValueError(f"{name}: keys {sorted(prefix)} are not a prefix of the tree's")
        return [a for k in sorted(tree) for a in prefix_leaves(prefix[k], tree[k], name)]
    if isinstance(prefix, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(prefix) != len(tree):
            raise ValueError(f"{name}: a sequence of {len(prefix)} is not a prefix of the tree")
        return [a for p, t in zip(prefix, tree) for a in prefix_leaves(p, t, name)]
    return [prefix] * len(tree_leaves(tree))
