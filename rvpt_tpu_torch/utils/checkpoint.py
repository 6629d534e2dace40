"""Checkpoint / resume (mirror of ``rvpt_tpu/utils/checkpoint.py``).

The reference's only resumable state is the temporal accumulation image
and its frame counter; here the film, the scene parameters and the camera
(and, for inverse rendering, optimizer state) serialize to one ``.npz``.
The file is the JAX package's: one array per leaf under the same key, the
JAX tree path (``['film']/.accum``: a dict key as ``['k']``, a dataclass
field as ``.f``, joined by ``/``), and the JSON ``__meta__``.  A film saved
by either package resumes in the other.

A tree is nested dicts and dataclasses whose leaves are tensors, arrays or
Python numbers.  A dataclass field marked ``metadata={"static": True}``
(the JAX package's ``static_field``) and a field holding None are not part
of the tree.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

STATIC = {"static": True}


def _items(tree, prefix=""):
    """(key, leaf) pairs of ``tree`` in the JAX flattening order: dict keys
    sorted, dataclass fields in declaration order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}[{k!r}]/")
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if f.metadata.get("static") or v is None:
                continue
            yield from _items(v, f"{prefix}.{f.name}/")
    else:
        yield prefix[:-1], tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree, meta: dict | None = None) -> None:
    """Save a tree of tensors (and JSON-serializable ``meta``) atomically."""
    leaves = {k: _host(v) for k, v in _items(tree)}
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp, __meta__=np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8),
        **leaves)
    # np.savez appends .npz when missing
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def _like(arr: np.ndarray, leaf):
    """``arr`` as the type of ``leaf``: a tensor of its dtype on its
    device, an array of its dtype, or a Python number."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(np.asarray(arr), device=leaf.device).to(leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return np.asarray(arr, dtype=leaf.dtype)
    return type(leaf)(arr)


def _rebuild(tree, data, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, data, f"{prefix}[{k!r}]/") for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        kw = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if not (f.metadata.get("static") or v is None):
                kw[f.name] = _rebuild(v, data, f"{prefix}.{f.name}/")
        return dataclasses.replace(tree, **kw)
    key = prefix[:-1]
    if key not in data:
        raise KeyError(f"checkpoint missing leaf {key}")
    return _like(data[key], tree)


def load(path: str, like):
    """Load into the structure of ``like`` (same tree shape, each leaf
    taking the type, dtype and device of ``like``'s); returns (tree, meta)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
        return _rebuild(like, data), meta
