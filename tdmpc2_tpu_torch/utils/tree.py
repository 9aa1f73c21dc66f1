"""The parameter trees' two operations: dicts and tuples of tensors, in the
JAX package's pytree order (dict keys sorted, as jax.tree.leaves takes
them), so a leaf list lines up with the JAX side's."""

from __future__ import annotations


def leaves(tree) -> list:
    """The tensors of `tree`, in JAX pytree order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (and of the same-shaped `rest`), in
    the order of `leaves`, keeping the structure: dicts stay dicts (keys
    sorted), lists and tuples become tuples."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return tuple(map(fn, v, *[r[i] for r in rest])
                     for i, v in enumerate(tree))
    return fn(tree, *rest)
