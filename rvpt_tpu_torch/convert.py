"""Carry scene, camera and film state across from the JAX package.

Each function takes a dict of numpy arrays (the JAX side calls
``np.asarray`` on its leaves) keyed by the JAX field names and returns the
port's object on ``device``.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.camera import Camera
from .ops.film import Film
from .scene.materials import Materials
from .scene.scene import ARRAY_FIELDS, Scene

_INT_FIELDS = ("tri_mat", "sph_mat", "pln_mat", "materials.kind")


def _tensor(name, value, device):
    dtype = torch.int64 if name in _INT_FIELDS else torch.float32
    return torch.as_tensor(np.array(value), device=device).to(dtype)


def scene_from_numpy(d: dict, device=None) -> Scene:
    """``d`` maps the JAX ``Scene`` fields (``tri_v0`` ... ``pln_mat``) and
    ``materials.albedo`` / ``.emission`` / ``.ior`` / ``.kind`` to arrays."""
    mats = Materials(**{
        k: _tensor(f"materials.{k}", d[f"materials.{k}"], device)
        for k in ("albedo", "emission", "ior", "kind")
    })
    return Scene(**{k: _tensor(k, d[k], device) for k in ARRAY_FIELDS},
                 materials=mats)


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
