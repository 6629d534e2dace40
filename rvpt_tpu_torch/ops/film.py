"""Film state: temporal EMA accumulation (mirror of ``rvpt_tpu/ops/film.py``).

The reference accumulates ``out = (accum * N + sample) / (N + 1)`` and
resets N on any camera or settings change (compute_pass.comp:146-166).
The film is ``(accum f32[3,H,W], frame)``; ``frame`` is a host int, so the
dirty check and the frame counter never wait on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Film:
    accum: torch.Tensor  # f32[3,H,W], channels first like the JAX film
    frame: int  # number of frames accumulated so far

    @staticmethod
    def create(height: int, width: int, device=None) -> "Film":
        return Film(
            accum=torch.zeros((3, height, width), dtype=torch.float32,
                              device=device),
            frame=0,
        )


def accumulate(film: Film, sample: torch.Tensor, dirty: bool) -> Film:
    """EMA update; ``dirty`` restarts accumulation at this sample (the
    reference zeroes the history, compute_pass.comp:146-149)."""
    frame = 0 if dirty else int(film.frame)
    n = float(frame)
    accum = film.accum if frame > 0 else torch.zeros_like(film.accum)
    new_accum = (accum * n + sample) / (n + 1.0)
    return Film(accum=new_accum, frame=frame + 1)


def to_srgb_u8(img: torch.Tensor) -> torch.Tensor:
    """Clamp linear radiance to u8 like an rgba8 UNORM image store (round
    half to even, as ``jnp.round``)."""
    return torch.clamp(torch.round(torch.clamp(img, 0.0, 1.0) * 255.0),
                       0, 255).to(torch.uint8)


def chw_to_hwc(img: torch.Tensor) -> torch.Tensor:
    return torch.movedim(img, 0, -1)


def hwc_to_chw(img: torch.Tensor) -> torch.Tensor:
    return torch.movedim(img, -1, 0)
