"""Trees of tensors: nested dicts and lists with tensor leaves (the
parameter, gradient and optimizer-state trees of training), walked in the
order ``jax.tree_util`` walks the reference's pytrees — a dict's keys
sorted, a list's items in order — so that a sum over the leaves (the
global norm) adds them in the reference's order."""
from __future__ import annotations

from typing import Callable


def tree_leaves(tree) -> list:
    """The leaves of ``tree``: dict keys sorted, list items in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` (in the order of
    :func:`tree_leaves`)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}          # the template's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(template)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees ``rest`` of its
    structure."""
    return tree_unflatten(tree, [fn(*leaves) for leaves in
                                 zip(tree_leaves(tree), *(tree_leaves(r) for r in rest))])
