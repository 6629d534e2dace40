"""A viewer's loop: ``Renderer.draw`` once per frame with the camera fixed,
the EMA film accumulating (the reference RVPT's real-time loop).

Inputs from the seed: each material's albedo and emission scaled by a
factor in [0.9, 1.1] (the paths, and so the work, do not depend on them),
and which frames are checked.  Checked: three frames drawn from the even
ones among the first 256 of the window, and its last frame.  Each is judged by what it says:
the reference's sample of that frame, folded into the program's film of
the frame before by the EMA, must give the program's film.
"""

from __future__ import annotations

import random

import torch

from .. import program
from ..reference import kajiya as ref

PLAN_SPAN = 256


class Loop:
    unit = "frame"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, scene_fn):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        g = torch.Generator(device=device).manual_seed(seed % 2**63)
        s = scene_fn(cfg["scene"], device)
        scale = lambda x: x * (0.9 + 0.2 * torch.rand(x.shape, generator=g, device=device))
        self.scene = s.replace(albedo=torch.clamp(scale(s.albedo), 0.0, 1.0),
                                   emission=scale(s.emission))
        self.width, self.height = cfg["film"]
        self.draws = 0
        self.stamps = []
        self.cuda = torch.device(device).type == "cuda"
        # Even offsets only: two checked frames never share a film, so every
        # seed holds as many films (and the peak memory does not move).
        self.plan = set(random.Random(seed).sample(range(0, PLAN_SPAN, 2), 3))
        self.held = {}
        self.prev = self.prev_draw = self.last = None
        self.log = lambda what: None

    def setup(self) -> None:
        from rvpt_tpu_torch.renderer import Renderer

        cam = program.port_camera(self.scene, self.width, self.height)
        self.renderer = Renderer(
            program.port_scene(self.scene), cam,
            program.settings(self.cfg["bounces"], self.cfg["style"],
                             self.traffic["integrator"]),
            program.film(self.width, self.height),
            frames_in_flight=self.traffic["frames_in_flight"])
        # Warm-up, holding each image so that the allocator caches as many
        # films as the window holds for its checks.
        self.log("renderer built")
        keep = [self.renderer.draw() for _ in range(self.traffic["warmup"])]
        self.renderer.flush()
        self.draws = self.first = len(keep)
        self.prev = keep[-1]
        del keep

    def iterate(self) -> None:
        img = self.renderer.draw()
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stamps.append(ev)
        if self.draws - self.first in self.plan:
            self.held[self.draws] = (self.prev, img)
        self.prev_draw, self.prev, self.last = self.prev, img, img
        self.draws += 1

    def drain(self) -> None:
        self.renderer.flush()

    def frames(self, iterations: int) -> list:
        """The RNG frames of the last ``iterations`` draws."""
        return list(range(self.draws - iterations, self.draws))

    def intervals_ms(self) -> list:
        """Device time between the ends of successive frames of the window."""
        return [a.elapsed_time(b) for a, b in zip(self.stamps, self.stamps[1:])]

    def close(self) -> None:
        """Keep the checked films, free the program's state."""
        self.held[self.draws - 1] = (self.prev_draw, self.last)
        del self.renderer, self.prev, self.prev_draw, self.last
        self.stamps = []

    # -- the check --------------------------------------------------------

    def _rays(self, tab_scene, pix, frame, dtype=torch.float32):
        if tab_scene.big_mesh():
            return ref.torch_rays(tab_scene, self.width, self.height, pix, frame,
                                  dtype=dtype)
        cam = ref.camera_vector(tab_scene, self.width, self.height)
        return ref.kernel_rays(cam, pix, frame, dtype=dtype)

    def pixels(self) -> torch.Tensor:
        """The checked pixel ids: every pixel, or the share of rows that the
        configuration's ``check_rows`` gives, drawn from the seed."""
        share = float(self.cfg.get("check_rows", 1.0))
        rows = list(range(self.height))
        if share < 1.0:
            rows = sorted(random.Random(self.seed ^ 0x5EED).sample(
                rows, max(1, round(share * self.height))))
        r = torch.tensor(rows, dtype=torch.int64, device=self.device)
        x = torch.arange(self.width, dtype=torch.int64, device=self.device)
        return (r[:, None] * self.width + x[None, :]).reshape(-1)

    def sample(self, frame, pix, dtype=torch.float32, census=None):
        """The reference's sample [3, n] of ``frame`` on pixels ``pix``."""
        s = self.scene
        tab = ref.Tables(s, dtype)
        with torch.no_grad():
            out = torch.cat([
                ref.trace(s, tab, self._rays(s, pix[i:i + ref.RAY_CHUNK], frame, dtype),
                          pix[i:i + ref.RAY_CHUNK], frame, ref.INTEGRATOR_SITE,
                          self.cfg["bounces"], self.cfg["style"],
                          tris_last=s.bvh, census=census)
                for i in range(0, pix.shape[0], ref.RAY_CHUNK)], dim=1)
        return out.float()

    def check(self, dtype=torch.float32) -> dict:
        """Share of checked pixels whose film the reference's sample does not
        give (``px_off``), over every checked frame."""
        pix = self.pixels()
        off = total = 0
        for k, (before, after) in sorted(self.held.items()):
            s_ref = self.sample(k, pix, dtype)
            off_k = film_off(before.reshape(3, -1)[:, pix], after.reshape(3, -1)[:, pix],
                             s_ref, k)
            off += int(off_k.sum())
            total += int(off_k.numel())
        return {"px_off": off / max(total, 1)}

    def control(self) -> dict:
        """``check``'s reading with the reference in bfloat16 in the
        program's place: each checked film made from the program's film
        before it and the bfloat16 sample."""
        pix = self.pixels()
        off = total = 0
        for k, (before, _) in sorted(self.held.items()):
            b = before.reshape(3, -1)[:, pix]
            s_ctl = self.sample(k, pix, torch.bfloat16)
            off_k = film_off(b, ref.ema(b, s_ctl, k), self.sample(k, pix), k)
            off += int(off_k.sum())
            total += int(off_k.numel())
        return {"px_off": off / max(total, 1)}

    def census(self, frames) -> list:
        """Per frame, the reference's count of K1's work on every pixel."""
        pix = torch.arange(self.width * self.height, device=self.device)
        out = []
        for f in frames:
            c = {}
            self.sample(f, pix, census=c)
            out.append({k: sum(v) for k, v in c.items()} | {"rays": int(pix.shape[0])})
        return out


def film_off(before, after, s_ref, k: int) -> torch.Tensor:
    """bool[n]: pixels whose film after frame ``k`` (``after``, [3, n]) is not
    the EMA of the film before it with the reference's sample ``s_ref``.
    The gap is read in units of the sample (times k + 1), against the
    rounding of the film's update (two ulps of the film per unit of k + 1)
    and 1e-4 of the sample."""
    want = ref.ema(before, s_ref, k)
    scale = float(k + 1)
    mag = torch.maximum(after.abs(), want.abs())
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    tol = 2.0 * scale * ulp + 1e-4 * (1.0 + s_ref.abs())
    gap = (after - want).abs() * scale
    return ((gap > tol) | ~torch.isfinite(after)).any(0)
