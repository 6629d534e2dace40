"""Carry scene, camera and film state across from the JAX package.

Each function takes a dict of numpy arrays (the JAX side calls
``np.asarray`` on its leaves) keyed by the JAX field names and returns the
port's object on ``device`` (None: the card).  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .models.camera import Camera
from .ops.film import Film
from .scene.bvh import Bvh, node_depths
from .scene.materials import Materials
from .scene.scene import ARRAY_FIELDS, Scene

_INT_FIELDS = ("tri_mat", "sph_mat", "pln_mat", "materials.kind")


def _tensor(name, value, device):
    dtype = torch.int64 if name in _INT_FIELDS else torch.float32
    return torch.as_tensor(np.array(value), device=resolve_device(device)).to(dtype)


def bvh_from_numpy(d: dict, device=None) -> Bvh:
    """``d`` holds the JAX ``Bvh`` arrays ``bvh.first``, ``bvh.count``,
    ``bvh.bmin``, ``bvh.bmax`` and the plain ``bvh.max_leaf``."""
    first = np.asarray(d["bvh.first"]).astype(np.int64)
    count = np.asarray(d["bvh.count"]).astype(np.int64)
    dev = resolve_device(device)
    return Bvh(
        first=torch.as_tensor(first, dtype=torch.int32, device=dev),
        count=torch.as_tensor(count, dtype=torch.int32, device=dev),
        bmin=torch.as_tensor(np.array(d["bvh.bmin"], np.float32), device=dev),
        bmax=torch.as_tensor(np.array(d["bvh.bmax"], np.float32), device=dev),
        max_leaf=int(d["bvh.max_leaf"]),
        depth=int(node_depths(first, count).max()),
        builder="converted")


def scene_from_numpy(d: dict, device=None) -> Scene:
    """``d`` maps the JAX ``Scene`` fields (``tri_v0`` ... ``pln_mat``) and
    ``materials.albedo`` / ``.emission`` / ``.ior`` / ``.kind`` to arrays;
    a BVH scene's dict also holds the ``bvh.*`` entries of
    ``bvh_from_numpy`` (its triangles are then in the tree's leaf order)."""
    mats = Materials(**{
        k: _tensor(f"materials.{k}", d[f"materials.{k}"], device)
        for k in ("albedo", "emission", "ior", "kind")
    })
    bvh = bvh_from_numpy(d, device) if "bvh.first" in d else None
    return Scene(**{k: _tensor(k, d[k], device) for k in ARRAY_FIELDS},
                 materials=mats, bvh=bvh)


def camera_from_numpy(d: dict, device=None) -> Camera:
    """``d`` holds ``translation``, ``rotation``, ``fov``, ``scale`` arrays
    and the plain ``aspect`` and ``mode``."""
    return Camera(
        **{k: _tensor(k, d[k], device)
           for k in ("translation", "rotation", "fov", "scale")},
        aspect=float(d["aspect"]),
        mode=int(d["mode"]),
    )


def film_from_numpy(d: dict, device=None) -> Film:
    """``d`` holds ``accum`` f32[3,H,W] and ``frame``."""
    return Film(accum=_tensor("accum", d["accum"], device),
                frame=int(d["frame"]))


def params_from_numpy(d: dict, device=None) -> dict:
    """``trainable_params`` dict (``materials.albedo``, ``scene.tri_v0``,
    ``camera.translation``, ...) from numpy arrays, as f32 tensors."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=dev).to(torch.float32)
            for k, v in d.items()}


def record_from_numpy(groups, n: int, device=None):
    """The port's flat ``PathRecord`` from a JAX ``collect_states`` record.

    ``groups`` lists the JAX record's bounce groups as numpy arrays:
    ``(g, states, fam, idx)`` with 13 ``states`` and ``fam``/``idx`` laid
    out as [grid, g*S, L] ray tiles (S sublanes of L lanes per tile, the
    rays in raster order); ``n`` is the number of rays."""
    from .ops.pathkernel import PathRecord

    fields, hits = [], []
    for g, states, fam, idx in groups:
        rs = fam.shape[1] // g

        def flat(a, b):
            return np.asarray(a)[:, b * rs:(b + 1) * rs, :].reshape(-1)[:n]

        for b in range(g):
            fields.append(np.stack([flat(s, b) for s in states]))
            hits.append(np.stack([flat(fam, b), flat(idx, b)]))
    dev = resolve_device(device)
    return PathRecord(
        torch.as_tensor(np.stack(fields).astype(np.float32), device=dev),
        torch.as_tensor(np.stack(hits).astype(np.int32), device=dev))
