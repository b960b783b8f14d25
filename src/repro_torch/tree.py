"""Nested-dict parameter trees in the JAX package's leaf order.

`jax.tree_util` visits a dict's keys SORTED, at every level, depth first;
so does every function here.  A flat row of the port (the sweep's [S, D]
state, the [S, U, D] gradient slab, the per-leaf noise draws) therefore
lays its leaves out exactly as the JAX package's row: for the paper MLP
b1 | b2 | w1 | w2, for the qwen3-shaped LM
blocks/b0/attn/{k_norm, q_norm, wk, wo, wq, wv} | blocks/b0/ffn/{wg, wi, wo}
| blocks/b0/{ln1, ln2} | embed | final_norm | lm_head.

A tree is a dict whose values are trees or leaves; anything that is not a
dict is a leaf.  `torch.utils._pytree` is not used: it keeps a dict's
insertion order, which is not JAX's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Tree = Any
_END = object()


def _walk(tree: Tree, prefix: Tuple[str, ...]
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _walk(tree[k], prefix + (k,))


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves of `tree`, keys sorted at every level, depth first."""
    return [leaf for _, leaf in _walk(tree, ())]


def tree_paths(tree: Tree) -> List[str]:
    """The "/"-joined key path of every leaf, in `tree_leaves` order."""
    return ["/".join(path) for path, _ in _walk(tree, ())]


def _structure(tree: Tree) -> Tree:
    """The tree with every leaf replaced by None: the treedef that
    `tree_unflatten` fills."""
    if not isinstance(tree, dict):
        return None
    return {k: _structure(v) for k, v in tree.items()}


def tree_flatten(tree: Tree) -> Tuple[List[Any], Tree]:
    """(leaves in `tree_leaves` order, treedef)."""
    return tree_leaves(tree), _structure(tree)


def tree_unflatten(treedef: Tree, leaves) -> Tree:
    """The inverse of `tree_flatten`: a tree shaped like `treedef`, its
    leaves taken from `leaves` in sorted-key depth-first order."""
    it = iter(leaves)

    def fill(node):
        if not isinstance(node, dict):
            return next(it)
        return {k: fill(node[k]) for k in sorted(node)}

    out = fill(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn applied leaf by leaf over `tree` and trees of the same structure
    (`rest`); the result has `tree`'s structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    for r in rest:
        if not isinstance(r, dict) or set(r) != set(tree):
            raise ValueError(f"tree structures differ: keys {sorted(tree)} "
                             f"vs {sorted(r) if isinstance(r, dict) else r}")
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def tree_size(tree: Tree) -> int:
    """Total number of scalar entries across the tensor leaves."""
    return sum(int(x.numel()) for x in tree_leaves(tree))

