"""Nested containers of tensors (parameters, gradients, optimizer state):
the few tree operations the trainer, the optimizer and the checkpoints
share.  A tree is a dict, list or tuple of trees, or a leaf; a dict is
walked in sorted key order, as ``jax.tree_util`` flattens one, so a
checkpoint's leaf files line up with the reference's."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves in flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of ``rest``, trees of the same
    structure; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
