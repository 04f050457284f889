"""Nested containers of tensors (dicts, lists, tuples), the counterpart of
the reference's ``jax.tree_util`` where the port needs it: the checkpoint
store's key paths, and the optimizer's leaf-by-leaf maps.  Dict keys are
taken in sorted order and ``None`` is an empty subtree, as in JAX."""

from __future__ import annotations

from typing import Any, Callable


def flatten_with_path(tree) -> list[tuple[tuple, Any]]:
    """[(key path, leaf)] in JAX's order: dict keys sorted, list and
    tuple items by index."""
    out: list = []
    _walk(tree, (), out)
    return out


def _walk(node, path: tuple, out: list) -> None:
    # a module-level function: a recursive closure would be a reference
    # cycle holding ``out`` (and so every leaf) until the next collection
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (k,), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, path + (i,), out)
    else:
        out.append((path, node))


def path_key(path: tuple) -> str:
    """A key path as the reference's checkpoint names it: its keys and
    indices joined with ``/``."""
    return "/".join(str(k) for k in path)


def leaves(tree) -> list:
    return [leaf for _p, leaf in flatten_with_path(tree)]


def map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(key path, leaf)`` over the leaves of ``tree``; its structure
    back."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the structure of ``tree``
    back."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
