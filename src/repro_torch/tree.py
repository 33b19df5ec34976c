"""Nested dict/list trees of tensors: the port's parameter and cache trees.

The reference keeps parameters and caches as JAX pytrees and walks them with
`jax.tree` (through `repro.kernels.compat`). The port keeps the same nesting
of dicts and lists, so a tree compares leaf for leaf with the reference's,
and walks it with these helpers. Paths render as "a/b/0/c", as the
reference's `compat.tree_path_str` does.
"""

from __future__ import annotations

from typing import Any, Callable


def map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any,
                  path: str = "") -> Any:
    """Apply `fn(path, leaf, *other_leaves)` over `tree` and trees of the same
    structure, keeping the structure. Dict keys are walked in sorted order,
    as `jax.tree` walks them."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 path=f"{path}/{k}" if path else str(k))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, t, *(r[i] for r in rest),
                             path=f"{path}/{i}" if path else str(i))
               for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(path, tree, *rest)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def leaves_with_path(tree: Any) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    map_with_path(lambda p, x: out.append((p, x)), tree)
    return out
