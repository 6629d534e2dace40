"""Stateless counter-based RNG: PCG3D/PCG4D, bit-exact with
``rvpt_tpu/core/rng.py``.

Every draw is a pure function of ``(pixel, frame, salt)``, so no generator
state exists anywhere.  PyTorch's CPU ``uint32`` has no ``+`` or ``>>``, so
the hash runs on int64 lanes holding u32 values, masked back to 32 bits
after every ``*`` and ``+`` (a wrapped int64 product keeps its low 32 bits
exact).  Inputs may be tensors or Python ints; outputs are int64 tensors in
[0, 2^32).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_LCG_MUL = 1664525
_LCG_ADD = 1013904223
_INV_2_24 = 1.0 / 16777216.0


def _u32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    device = like.device if like is not None else None
    return torch.tensor(int(x) & _MASK, dtype=torch.int64, device=device)


def _first_tensor(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x
    return None


def pcg3d(v0, v1, v2):
    """PCG3D hash: three u32 streams in, three decorrelated u32 streams out."""
    like = _first_tensor(v0, v1, v2)
    x, y, z = _u32(v0, like), _u32(v1, like), _u32(v2, like)
    x = (x * _LCG_MUL + _LCG_ADD) & _MASK
    y = (y * _LCG_MUL + _LCG_ADD) & _MASK
    z = (z * _LCG_MUL + _LCG_ADD) & _MASK
    x = (x + y * z) & _MASK
    y = (y + z * x) & _MASK
    z = (z + x * y) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + y * z) & _MASK
    y = (y + z * x) & _MASK
    z = (z + x * y) & _MASK
    return x, y, z


def pcg4d(v0, v1, v2, v3):
    """PCG4D hash: four u32 streams in, four decorrelated u32 streams out."""
    like = _first_tensor(v0, v1, v2, v3)
    x, y, z, w = (_u32(v, like) for v in (v0, v1, v2, v3))
    x = (x * _LCG_MUL + _LCG_ADD) & _MASK
    y = (y * _LCG_MUL + _LCG_ADD) & _MASK
    z = (z * _LCG_MUL + _LCG_ADD) & _MASK
    w = (w * _LCG_MUL + _LCG_ADD) & _MASK
    x = (x + y * w) & _MASK
    y = (y + z * x) & _MASK
    z = (z + x * w) & _MASK
    w = (w + y * z) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + y * w) & _MASK
    y = (y + z * x) & _MASK
    z = (z + x * w) & _MASK
    w = (w + y * z) & _MASK
    return x, y, z, w


def u32_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits of a u32 -> float32 uniform in [0, 1) (exact)."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def uniform3(pixel, frame, salt):
    """Three independent uniforms in [0,1) per lane, keyed (pixel, frame,
    salt) — the same streams as ``rvpt_tpu.core.rng.uniform3``."""
    a, b, c = pcg3d(pixel, frame, salt)
    return u32_to_unit_float(a), u32_to_unit_float(b), u32_to_unit_float(c)


def uniform4(pixel, frame, salt, salt2):
    a, b, c, d = pcg4d(pixel, frame, salt, salt2)
    return (
        u32_to_unit_float(a),
        u32_to_unit_float(b),
        u32_to_unit_float(c),
        u32_to_unit_float(d),
    )


def uniform2(pixel, frame, salt):
    a, b, _ = uniform3(pixel, frame, salt)
    return a, b


def uniform1(pixel, frame, salt):
    (a, _, _) = uniform3(pixel, frame, salt)
    return a
