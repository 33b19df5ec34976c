"""Nested dict/list trees of tensors: the port's parameter and cache trees.

The reference keeps parameters and caches as JAX pytrees and walks them with
`jax.tree` (through `repro.kernels.compat`). The port keeps the same nesting
of dicts and lists, so a tree compares leaf for leaf with the reference's,
and walks it with these helpers. Paths render as "a/b/0/c", as the
reference's `compat.tree_path_str` does.

Other node types join through `register_node`, as a class joins `jax.tree`
through pytree registration: the walk goes into the node's children (a
dict) and rebuilds the node with its static data, unless `is_leaf` stops it
there. The packed weights of `models.dispatched` register themselves so.
"""

from __future__ import annotations

from typing import Any, Callable

IsLeaf = Callable[[Any], bool] | None
# flatten(node) -> (static, children): `static` a hashable, printable tuple,
# `children` a dict of subtrees; unflatten(static, children) -> node
Flatten = Callable[[Any], tuple[tuple, dict]]
Unflatten = Callable[[tuple, dict], Any]

_NODES: dict[type, tuple[Flatten, Unflatten]] = {}


def register_node(cls: type, flatten: Flatten, unflatten: Unflatten) -> None:
    _NODES[cls] = (flatten, unflatten)


def flatten_node(x: Any) -> tuple[tuple, dict] | None:
    """(static, children) of a registered node, None for anything else."""
    reg = _NODES.get(type(x))
    return None if reg is None else reg[0](x)


def map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any,
                  path: str = "", is_leaf: IsLeaf = None) -> Any:
    """Apply `fn(path, leaf, *other_leaves)` over `tree` and trees of the same
    structure, keeping the structure. Dict keys are walked in sorted order,
    as `jax.tree` walks them; a subtree for which `is_leaf` is true is
    handed to `fn` whole."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)

    def sub(key, child, *others):
        return map_with_path(fn, child, *others, path=f"{path}/{key}" if path else str(key),
                             is_leaf=is_leaf)

    reg = _NODES.get(type(tree))
    if reg is not None:
        flatten, unflatten = reg
        static, kids = flatten(tree)
        others = [flatten(r)[1] for r in rest]
        return unflatten(static, {k: sub(k, kids[k], *(o[k] for o in others))
                                  for k in sorted(kids)})
    if isinstance(tree, dict):
        return {k: sub(k, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(i, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any, is_leaf: IsLeaf = None) -> Any:
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest, is_leaf=is_leaf)


def leaves_with_path(tree: Any, is_leaf: IsLeaf = None) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    map_with_path(lambda p, x: out.append((p, x)), tree, is_leaf=is_leaf)
    return out
