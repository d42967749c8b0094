"""Nested dicts and lists of tensors (the port's state trees), walked in
the order JAX flattens a pytree: a dict's keys sorted, a list's or tuple's
items by index.  A leaf is anything that is not a dict, list or tuple.

Paths are tuples of dict keys and list indices; ``path_str`` joins them as
the reference checkpointer does (``params/blocks/0/attn/wq``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def leaves_with_paths(tree, is_leaf: Callable[[Any], bool] = None,
                      prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in JAX's flattening order."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[Path, Any]] = []
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    for k, sub in items:
        out.extend(leaves_with_paths(sub, is_leaf, prefix + (k,)))
    return out


def leaves(tree, is_leaf: Callable[[Any], bool] = None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf)]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable[[Any], bool] = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of that
    structure."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    out = [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
           for i, t in enumerate(tree)]
    return tuple(out) if isinstance(tree, tuple) else out


def unflatten_like(tree, new_leaves: List[Any],
                   is_leaf: Callable[[Any], bool] = None):
    """``tree``'s structure with its leaves replaced, in flattening order,
    by ``new_leaves``."""
    it = iter(new_leaves)
    order = leaves_with_paths(tree, is_leaf)
    by_path = {p: next(it) for p, _ in order}
    return _rebuild(tree, by_path, (), is_leaf)


def _rebuild(tree, by_path, prefix: Path, is_leaf):
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return by_path[prefix]
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_path, prefix + (k,), is_leaf)
                for k, v in tree.items()}
    out = [_rebuild(v, by_path, prefix + (i,), is_leaf)
           for i, v in enumerate(tree)]
    return tuple(out) if isinstance(tree, tuple) else out


def path_str(path: Path) -> str:
    return "/".join(str(p) for p in path)
