"""Materials as a structure of arrays (mirror of
``rvpt_tpu/scene/materials.py``): ``albedo``/``emission``/``ior`` are float
tensors, ``kind`` an int64 code."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.device import resolve_device

LAMBERT = 0
MIRROR = 1
DIELECTRIC = 2

MATERIAL_NAMES = {"lambert": LAMBERT, "mirror": MIRROR, "dielectric": DIELECTRIC}


@dataclass(frozen=True)
class Materials:
    albedo: torch.Tensor  # f32[M,3]
    emission: torch.Tensor  # f32[M,3]
    ior: torch.Tensor  # f32[M]
    kind: torch.Tensor  # i64[M]

    @property
    def count(self) -> int:
        return self.albedo.shape[0]

    @staticmethod
    def empty(device=None) -> "Materials":
        device = resolve_device(device)
        return Materials(
            albedo=torch.zeros((0, 3), dtype=torch.float32, device=device),
            emission=torch.zeros((0, 3), dtype=torch.float32, device=device),
            ior=torch.zeros((0,), dtype=torch.float32, device=device),
            kind=torch.zeros((0,), dtype=torch.int64, device=device),
        )

    @staticmethod
    def from_list(mats: list[dict], device=None) -> "Materials":
        """Build from dicts with keys albedo, emission, kind, optional ior."""
        device = resolve_device(device)
        if not mats:
            return Materials.empty(device)
        f32 = dict(dtype=torch.float32, device=device)
        return Materials(
            albedo=torch.tensor([m["albedo"] for m in mats], **f32),
            emission=torch.tensor([m["emission"] for m in mats], **f32),
            ior=torch.tensor([m.get("ior", 1.5) for m in mats], **f32),
            kind=torch.tensor([m["kind"] for m in mats], dtype=torch.int64,
                              device=device),
        )


def gather(mats: Materials, idx: torch.Tensor) -> Materials:
    """Per-hit material rows; out-of-range ids (misses) clamp to row 0 and
    callers mask by hit validity.  A material-less scene yields zeroed rows."""
    if mats.count == 0:
        n = tuple(idx.shape)
        dev = idx.device
        return Materials(
            albedo=torch.zeros((*n, 3), dtype=torch.float32, device=dev),
            emission=torch.zeros((*n, 3), dtype=torch.float32, device=dev),
            ior=torch.ones(n, dtype=torch.float32, device=dev),
            kind=torch.zeros(n, dtype=torch.int64, device=dev),
        )
    safe = torch.clamp(idx, 0, mats.count - 1)
    return Materials(
        albedo=mats.albedo[safe],
        emission=mats.emission[safe],
        ior=mats.ior[safe],
        kind=mats.kind[safe],
    )
