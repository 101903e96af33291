"""Trees of tensors walked as ``jax.tree`` walks them, for the training path
and checkpoints: dict keys in sorted order, lists and tuples in order, a
NamedTuple by its fields, ``None`` a node with no leaves, anything else a
leaf. A leaf's path is the tuple of its keys as strings (dict key, list or
tuple index, NamedTuple field name), the parts the reference's checkpoint
joins into a file name. A tree of specs (``models.param_shardings``) holds
plain tuples as its leaves, walked beside the tree it describes by
``map_specs``."""
from __future__ import annotations

from repro_torch.runtime.validate import SpgemmInputError


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree, prefix: tuple = ()) -> list:
    """[(path, leaf), ...] in the reference's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(leaves_with_path(sub, prefix + (key,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(tree_like, new_leaves):
    """``tree_like``'s structure with ``new_leaves`` in flattening order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(tree_like)
    if next(it, None) is not None:
        raise SpgemmInputError("more leaves than the tree holds")
    return out


def tree_map(fn, tree):
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def is_spec(x) -> bool:
    """A spec tuple (a leaf of a spec tree), not a NamedTuple node."""
    return isinstance(x, tuple) and not _is_namedtuple(x)


def map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree and the matching tree, in the
    spec tree's structure."""
    if is_spec(specs):
        return fn(specs, tree)
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], tree[k]) for k in sorted(specs)}
    return type(specs)(*(map_specs(fn, s, t) for s, t in zip(specs, tree))) \
        if _is_namedtuple(specs) else type(specs)(map_specs(fn, s, t) for s, t in zip(specs, tree))
