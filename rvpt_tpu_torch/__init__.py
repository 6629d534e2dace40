"""rvpt_tpu_torch: the rvpt_tpu path tracer ported to PyTorch and CUDA.

A second package beside ``rvpt_tpu`` (the JAX reference, which it never
imports).  Module paths and names mirror ``rvpt_tpu`` one to one.  Plain
tensor code is PyTorch; each Pallas kernel of ``rvpt_tpu`` that the port
has reached (K1, K2, B3, B4 and B8 so far) is hand-written CUDA C++ for
Hopper under ``csrc/``, built at first use.  A CPU tensor takes each kernel's plain
PyTorch version; a CUDA tensor launches the kernel or raises.  Entry
points build on the card unless the caller passes ``device="cpu"``.
"""

from .config import FilmConfig, RenderSettings
from .core.device import resolve_device
from .core.types import Isect, Ray
from .models.camera import Camera
from .ops.film import Film
from .scene.scene import Scene, SceneBuilder

__version__ = "0.1.0"


__all__ = [
    "Camera",
    "Film",
    "FilmConfig",
    "Isect",
    "Ray",
    "RenderSettings",
    "Scene",
    "SceneBuilder",
    "resolve_device",
]
