"""rvpt_tpu_torch: the rvpt_tpu path tracer ported to PyTorch and CUDA.

A second package beside ``rvpt_tpu`` (the JAX reference, which it never
imports).  Module paths and names mirror ``rvpt_tpu`` one to one.  Plain
tensor code is PyTorch; the whole-path kernel (the Pallas kernel K1 of
``rvpt_tpu.ops.pathkernel``) is hand-written CUDA C++ for Hopper under
``csrc/``, built at first use.  A CPU tensor takes each kernel's plain
PyTorch version; a CUDA tensor launches the kernel or raises.
"""

import torch

from .config import FilmConfig, RenderSettings
from .core.types import Isect, Ray
from .models.camera import Camera
from .ops.film import Film
from .scene.scene import Scene, SceneBuilder

__version__ = "0.1.0"


def default_device() -> torch.device:
    """``cuda`` when a card is present, else ``cpu``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


__all__ = [
    "Camera",
    "Film",
    "FilmConfig",
    "Isect",
    "Ray",
    "RenderSettings",
    "Scene",
    "SceneBuilder",
    "default_device",
]
