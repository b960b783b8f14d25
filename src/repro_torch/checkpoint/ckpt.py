"""Tree checkpointing: a flat-npz payload and a JSON manifest.

The counterpart of `repro/checkpoint/ckpt.py`, in the same on-disk format,
so each package reads the other's files.  Two files a checkpoint:

  <base>.npz        every leaf as a numpy array, keyed by its "/"-joined
                    path (dict keys and sequence indices); dtypes numpy
                    cannot store (bfloat16, fp8) are stored as raw uint8
                    bytes
  <base>.meta.json  the manifest: format version, leaf keys, true shapes
                    and dtype names (the names numpy / ml_dtypes print:
                    "float32", "bfloat16", "float8_e4m3fn"), which leaves
                    are byte-packed, and an `extra` dict for the caller

A tree is nested dicts, lists and tuples; a leaf is a torch tensor, a numpy
array or a scalar.  Dict keys are visited in sorted order (the reference's
`tree_flatten` order) and must not contain "/"; None is an empty subtree.

Writes go through `.tmp` paths and `os.replace`, the manifest LAST, so its
presence commits the checkpoint; rewriting a committed base unlinks the old
manifest before the payload is swapped, so a crash leaves at most a payload
without a manifest, which `latest_step` ignores.  A failed write unlinks
its own temp files.

Step-indexed layout (the sweep engine's resume):

  save_pytree(dir, step, tree, extra=...)  -> <dir>/ckpt_<step>.{npz,meta.json}
  restore_pytree(dir, step=None, template=...)   # step=None: the latest
  latest_step(dir)                         # highest COMMITTED step, or None

Restored leaves are CPU tensors, byte-exact for every dtype (bfloat16, fp8
and complex included).  `template=` rebuilds the template's containers
(tuples stay tuples); without it the tree is rebuilt from the paths, dicts
keyed by path component, with keys 0..n-1 folded into lists.  The `save` /
`restore` shims keep the reference's params / opt_state signatures.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1

_META = ".meta.json"
_PAYLOAD = ".npz"


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> Dict[str, Any]:
    """{"/"-joined path: leaf}, dicts in sorted key order."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {"/".join(prefix): tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten_with_paths(v, prefix + (k,)))
    return flat


def _unflatten_like(template, flat: Dict[str, Any],
                    prefix: Tuple[str, ...] = ()):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_like(v, flat, prefix + (str(i),))
                              for i, v in enumerate(template))
    return flat["/".join(prefix)]


def _rebuild_from_paths(flat: Dict[str, Any]):
    """Nested containers from the "/"-joined path keys alone: dicts keyed
    by path component, a dict whose keys are exactly 0..n-1 as a list."""
    if set(flat) == {""}:   # a bare leaf
        return flat[""]
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def fold(node):
        if not isinstance(node, dict):
            return node
        node = {k: fold(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            idx = sorted(int(k) for k in node)
            if idx == list(range(len(node))):
                return [node[str(i)] for i in idx]
        return node

    return fold(root)


def _to_numpy(leaf) -> Tuple[np.ndarray, str, list]:
    """A leaf as (npz-safe array, dtype name, true shape).  Dtypes numpy
    lacks (bfloat16, fp8) become their raw bytes, flat uint8, under the
    name ml_dtypes gives them (torch's name without "torch.")."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        try:
            a = t.numpy()
        except TypeError:
            raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
            return raw, str(t.dtype).replace("torch.", ""), list(t.shape)
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype), list(a.shape)


# numpy dtypes torch.from_numpy takes, stored as themselves; every other
# dtype rides as raw bytes under its name (bfloat16 and the float8 formats,
# from torch or from ml_dtypes: this writer packs every one of them, where
# the reference packs only those numpy reports as kind "V").
_NUMPY_NATIVE = frozenset(np.dtype(t) for t in (
    np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
    np.uint32, np.uint64, np.float16, np.float32, np.float64, np.complex64,
    np.complex128))


def _from_packed(raw: np.ndarray, name: str, shape) -> torch.Tensor:
    """Raw bytes -> a tensor of dtype `name` (a numpy name, or one torch
    has and numpy lacks: "bfloat16", "float8_e4m3fn", ...)."""
    tdt = getattr(torch, name, None)
    if isinstance(tdt, torch.dtype) and tdt.is_floating_point and \
            tdt not in (torch.float16, torch.float32, torch.float64):
        data = torch.frombuffer(bytearray(raw.tobytes()), dtype=torch.uint8)
        return data.view(tdt).reshape(shape)
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    if dt not in _NUMPY_NATIVE:
        raise ValueError(f"checkpoint leaf dtype {name!r} has no torch "
                         f"dtype to restore it as")
    return torch.from_numpy(
        np.frombuffer(raw.tobytes(), dt).reshape(shape).copy())


def _cleanup(*paths: str) -> None:
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass


def write_tree(base: str, tree, extra: Optional[dict] = None) -> str:
    """Write one checkpoint at <base>.npz + <base>.meta.json (atomic: temp
    files renamed into place, the manifest last, its presence the commit).
    Returns the payload path."""
    arrays, shapes, dtypes, packed = {}, {}, {}, []
    for k, leaf in _flatten_with_paths(tree).items():
        a, name, shape = _to_numpy(leaf)
        if name != str(a.dtype) or a.dtype not in _NUMPY_NATIVE:
            a = np.frombuffer(np.ascontiguousarray(a).tobytes(), np.uint8)
            packed.append(k)
        arrays[k], shapes[k], dtypes[k] = a, shape, name
    meta = {
        "format_version": FORMAT_VERSION,
        "keys": sorted(arrays),
        "shapes": shapes,
        "dtypes": dtypes,
        "packed": sorted(packed),
        "extra": extra or {},
    }
    tmp_npz = base + ".tmp" + _PAYLOAD
    tmp_meta = base + _META + ".tmp"
    try:
        np.savez(tmp_npz, **arrays)
        with open(tmp_meta, "w") as f:
            json.dump(meta, f)
        # Never pair the old manifest with the new payload: decommit first,
        # swap the payload, then rename the new manifest (the commit).
        try:
            os.remove(base + _META)
        except FileNotFoundError:
            pass
        os.replace(tmp_npz, base + _PAYLOAD)
        os.replace(tmp_meta, base + _META)
    except BaseException:
        _cleanup(tmp_npz, tmp_meta)
        raise
    return base + _PAYLOAD


def read_tree(base: str, template=None) -> Tuple[Any, dict]:
    """Read a checkpoint written by `write_tree` (by either package).
    Returns (tree, meta): CPU tensors byte-exact as stored, containers from
    `template` when given, else rebuilt from the recorded paths."""
    with open(base + _META) as f:
        meta = json.load(f)
    with np.load(base + _PAYLOAD) as z:
        raw = {k: z[k] for k in z.files}
    packed = set(meta.get("packed", ()))
    flat = {k: (_from_packed(v, meta["dtypes"][k], meta["shapes"][k])
                if k in packed else torch.from_numpy(np.array(v)))
            for k, v in raw.items()}
    tree = (_rebuild_from_paths(flat) if template is None
            else _unflatten_like(template, flat))
    return tree, meta


def _base(path: str, step: int) -> str:
    return os.path.join(path, f"ckpt_{step}")


def save_pytree(path: str, step: int, tree,
                extra: Optional[dict] = None) -> str:
    """Write `tree` as step `step` under directory `path` (created if
    needed); atomic, see `write_tree`.  Returns the payload path."""
    os.makedirs(path, exist_ok=True)
    extra = dict(extra or {})
    extra.setdefault("step", int(step))
    return write_tree(_base(path, step), tree, extra=extra)


def restore_pytree(path: str, step: Optional[int] = None,
                   template=None) -> Tuple[Any, dict]:
    """Read step `step` (None: `latest_step(path)`) from directory `path`.
    Raises FileNotFoundError when the directory holds no committed step."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {path!r}")
    return read_tree(_base(path, step), template=template)


def latest_step(path: str) -> Optional[int]:
    """Highest COMMITTED step in `path`: a step counts only when both its
    payload and its manifest exist, so torn writes and foreign files are
    ignored."""
    if not os.path.isdir(path):
        return None
    steps = []
    for f in os.listdir(path):
        if not (f.startswith("ckpt_") and f.endswith(_PAYLOAD)):
            continue
        stem = f[len("ckpt_"):-len(_PAYLOAD)]
        if stem.isdigit() and os.path.exists(
                os.path.join(path, f"ckpt_{stem}{_META}")):
            steps.append(int(stem))
    return max(steps) if steps else None


# The reference's params / opt_state signatures, on top of the tree format.


def save(path: str, step: int, params, opt_state=None,
         extra: Optional[dict] = None) -> str:
    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    return save_pytree(path, step, tree, extra=extra)


def restore(path: str, step: int, params_template, opt_template=None
            ) -> Tuple[Any, Any, dict]:
    """Leaves cast to the template's dtypes (a no-op on this format)."""
    tmpl = {"params": params_template}
    if opt_template is not None:
        tmpl["opt_state"] = opt_template
    tree, meta = restore_pytree(path, step, template=tmpl)
    flat_t = _flatten_with_paths(tmpl)
    flat = {k: torch.as_tensor(v).to(torch.as_tensor(flat_t[k]).dtype)
            for k, v in _flatten_with_paths(tree).items()}
    tree = _unflatten_like(tmpl, flat)
    return (tree["params"],
            tree.get("opt_state") if opt_template is not None else None,
            meta)
