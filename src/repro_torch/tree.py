"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

Parameters, adapters and caches are plain nested dicts of tensors with the
same keys as the JAX package's pytrees, so carrying weights across is a
plain copy leaf by leaf (``checkpoint/io.params_from_numpy``).  A packed
base leaf (:class:`~repro_torch.core.quant.QuantizedLinear`) is a node with
two children, ``data`` and ``scales``, as it is a pytree node with those
children in the JAX package: ``tree_map`` applies ``fn`` to both (so
slicing one layer off a repeat-stacked packed weight slices both) and
``tree_leaves`` lists both."""
from __future__ import annotations

import dataclasses

from repro_torch.core.quant import QuantizedLinear


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over nested dicts of equal structure;
    ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, QuantizedLinear):
        return QuantizedLinear(fn(tree.data, *(r.data for r in rest)),
                               fn(tree.scales, *(r.scales for r in rest)),
                               tree.bits, tree.group_size, tree.k,
                               tree.out_dtype)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (the order ``jax.tree.leaves`` uses for
    dicts), so "first leaf" means the same thing in both packages."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if tree is None:
        return []
    if isinstance(tree, QuantizedLinear):
        return [tree.data, tree.scales]
    return [tree]


def tree_unflatten(tree, leaves):
    """``leaves``, listed in :func:`tree_leaves`' sorted-key order, put back
    into ``tree``'s structure (whose dicts keep their own key order), as
    ``jax.tree.unflatten`` does with ``jax.tree.leaves``' list."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            vals = {k: walk(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if node is None:
            return None
        if isinstance(node, QuantizedLinear):
            return QuantizedLinear(next(it), next(it), node.bits,
                                   node.group_size, node.k, node.out_dtype)
        return next(it)

    return walk(tree)


def tree_flatten(tree):
    """(leaves, treedef), as ``jax.tree_util.tree_flatten`` returns them
    for a call's arguments: dicts (in sorted-key order), tuples, lists and
    dataclass instances are nodes, a packed leaf is a node with its two
    children, None is an empty node, anything else a leaf.  ``treedef`` is
    a hashable description of the structure: two trees with one treedef
    differ only in their leaves."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            return ("dict", tuple((k, walk(node[k])) for k in sorted(node)))
        if isinstance(node, (tuple, list)):
            return (type(node).__name__, tuple(walk(x) for x in node))
        if node is None:
            return ("none",)
        if isinstance(node, QuantizedLinear):
            leaves.extend([node.data, node.scales])
            return ("packed", node.bits, node.group_size, node.k,
                    str(node.out_dtype))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return (type(node).__name__, tuple(
                (f.name, walk(getattr(node, f.name)))
                for f in dataclasses.fields(node)))
        leaves.append(node)
        return ("leaf",)

    treedef = walk(tree)
    return leaves, treedef
