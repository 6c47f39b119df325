"""The reference's pytree order on the port's parameter and state trees.

A tree is a dict, list or tuple of subtrees with tensors (or arrays) at
the leaves; a :class:`repro_torch.models.model.Model` stands for its
``tree()``.  Dict keys are visited in sorted order and sequences by index,
as JAX flattens a pytree, so a leaf's path names it as the reference's
checkpoints do (``("blocks", 0, "wq")`` -> ``blocks_0_wq``).
"""

from __future__ import annotations


def as_tree(tree):
    return tree.tree() if hasattr(tree, "tree") else tree


def leaves_with_paths(tree, prefix: tuple = ()):
    """(path, leaf) for every leaf, in the reference's order."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree):
    """A tree of the same structure (a Model gives its dict tree) with
    ``fn(leaf)`` at each leaf, visited in :func:`leaves_with_paths` order."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten(tree, flat) -> object:
    """``flat`` (in :func:`leaves_with_paths` order) in ``tree``'s shape."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def subtree(tree, path):
    node = as_tree(tree)
    for key in path:
        node = as_tree(node[key])
    return node
