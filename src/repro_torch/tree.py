"""Minimal pytree helpers over the nested dict / tuple / list parameter and
cache structures the port shares with the reference."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to matching leaves of one or more same-shaped trees.
    ``None`` subtrees stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over one tree; ``path`` is the tuple of dict keys
    and sequence positions leading to the leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, t, path + (i,))
                          for i, t in enumerate(tree))
    return fn(path, tree)
