"""Batched ray and intersection records (mirror of ``rvpt_tpu/core/types.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Ray:
    """A batch of rays: ``origin`` and ``direction`` are f32[N, 3]."""

    origin: torch.Tensor
    direction: torch.Tensor


@dataclass(frozen=True)
class Isect:
    """Batched intersection record.  ``t`` is +inf on a miss; ``prim`` and
    ``mat`` are -1 on a miss."""

    t: torch.Tensor  # f32[N]
    pos: torch.Tensor  # f32[N,3]
    normal: torch.Tensor  # f32[N,3], normalized, zero on a miss
    uv: torch.Tensor  # f32[N,2]
    prim: torch.Tensor  # i64[N]
    mat: torch.Tensor  # i64[N]

    @property
    def hit(self) -> torch.Tensor:
        return torch.isfinite(self.t)
