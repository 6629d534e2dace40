"""Render settings & film configuration (mirror of ``rvpt_tpu/config.py``).

The same frozen dataclasses, fields and JSON round trip.  Frozen and
hashable, so a settings object can key caches and the renderer's dirty
check.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass(frozen=True)
class RenderSettings:
    max_bounces: int = 8  # reference default rvpt.h:79
    aa: int = 1  # samples per pixel per frame, rvpt.h:80
    camera_mode: int = 0  # 0 pinhole / 1 ortho / 2 spherical
    # Split-screen integrator ids per quadrant; all default to Kajiya (9).
    top_left_render_mode: int = 9
    top_right_render_mode: int = 9
    bottom_left_render_mode: int = 9
    bottom_right_render_mode: int = 9
    split_ratio: tuple[float, float] = (0.5, 0.5)
    # 'reference' drops unfinished paths (integrators.glsl:675); 'standard'
    # keeps their accumulated emission.
    style: str = "reference"

    def modes(self) -> tuple[int, int, int, int]:
        return (
            self.top_left_render_mode,
            self.top_right_render_mode,
            self.bottom_left_render_mode,
            self.bottom_right_render_mode,
        )

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["split_ratio"] = list(d["split_ratio"])
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "RenderSettings":
        d = json.loads(s)
        if "split_ratio" in d:
            d["split_ratio"] = tuple(d["split_ratio"])
        return RenderSettings(**d)


@dataclass(frozen=True)
class FilmConfig:
    width: int = 1024  # reference fixed film, main.cpp:96-97
    height: int = 512

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def get_asset_path(relative: str) -> str:
    """Resolve a path under the project's assets directory (``config.py:71``
    of the JAX package): ``$RVPT_TPU_ASSETS`` first, then ``assets/`` at the
    checkout root beside this package, else the path as given."""
    import os

    override = os.environ.get("RVPT_TPU_ASSETS")
    roots = [override] if override else []
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots.append(os.path.join(pkg_root, "assets"))
    for root in roots:
        cand = os.path.join(root, relative)
        if os.path.exists(cand):
            return cand
    return relative
