"""Nested containers of tensors, as the reference walks its pytrees with
``jax.tree``: dicts (in sorted key order, as JAX flattens them), lists,
tuples and NamedTuples are nodes, ``None`` is an empty node, anything else
is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield str(key), tree[key]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        yield from zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield str(i), child


def _rebuild(tree, children: List[Any]):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*children)
    return type(tree)(children)


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), rebuilt in ``tree``'s shape."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    others = [dict(_children(r)) for r in rest]
    return _rebuild(tree, [tree_map(fn, child, *(o[k] for o in others))
                           for k, child in _children(tree)])


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)``, the path being the keys from the root joined by
    ``/``, as the reference names a checkpoint's leaves."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(prefix, tree)
    return _rebuild(tree, [
        tree_map_with_path(fn, child, f"{prefix}/{k}" if prefix else k)
        for k, child in _children(tree)])


def tree_leaves_with_path(tree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
