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
