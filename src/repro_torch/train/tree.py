"""Trees of tensors, the port's stand-in for ``jax.tree``: nested dicts and
lists (the port's param layout: one dict per layer in a list), with leaves
visited in ``jax.tree`` order — dict keys sorted, list items in order — so
sums over leaves and checkpoint keys match the reference's."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def is_quant_leaf(x) -> bool:
    """An 8-bit optimizer moment: ``{"q": int8, "s": fp32 scales}``."""
    return isinstance(x, dict) and set(x.keys()) == {"q", "s"}


def leaves_with_paths(tree, is_leaf: Callable[[Any], bool] = lambda x: False,
                      prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs, a path being the dict keys and list indices
    down to the leaf."""
    if is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], is_leaf, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, is_leaf, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree, is_leaf: Callable[[Any], bool] = lambda x: False) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf)]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable[[Any], bool] = lambda x: False):
    """``fn`` over the leaves of ``tree`` and the matching nodes of
    ``rest`` (trees of the same structure, or with leaves where ``tree``
    has them), keeping the structure; ``fn`` runs on the leaves in
    :func:`leaves` order."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf) for i, v in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree):
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping the
    structure; a path as in :func:`leaves_with_paths`."""

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(node[k], prefix + (k,)) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, prefix + (i,)) for i, v in enumerate(node))
        return fn(prefix, node)

    return walk(tree, ())
