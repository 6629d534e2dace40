"""Inverse rendering: recover scene parameters by gradient descent through
the path tracer (mirror of ``rvpt_tpu/train/inverse.py``).

Parameter groups (``PARAM_GROUPS``) select which leaves train: materials
(albedo/emission/ior), geometry (triangle vertices, sphere center/radius,
plane normal/offset) and camera pose (translation/rotation), every leaf the
paired trace of ``ops.fast_grad`` returns cotangents for.  The optimizer is
``torch.optim.Adam`` with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8
added after the square root).  With a ``(tiles, spp)`` device mesh each
rank renders its own pixels and samples and the scene gradients are summed
over every rank before the step (``parallel.sharded``), so the parameters
stay equal on every rank.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import FilmConfig, RenderSettings
from ..render import render_sample_chw
from ..scene.scene import Scene
from ..utils.profiling import annotate

# group name -> tuple of (container, leaf) addresses
PARAM_GROUPS = {
    "albedo": (("materials", "albedo"),),
    "emission": (("materials", "emission"),),
    "ior": (("materials", "ior"),),
    "vertices": (("scene", "tri_v0"), ("scene", "tri_v1"),
                 ("scene", "tri_v2")),
    "spheres": (("scene", "sph_center"), ("scene", "sph_radius")),
    "planes": (("scene", "pln_normal"), ("scene", "pln_d")),
    "camera": (("camera", "translation"), ("camera", "rotation")),
}

DEFAULT_GROUPS = ("albedo", "emission")


def _group_leaves(groups):
    seen = []
    for g in groups:
        if g not in PARAM_GROUPS:
            raise ValueError(
                f"unknown param group {g!r}; known: {sorted(PARAM_GROUPS)}")
        seen.extend(PARAM_GROUPS[g])
    return seen


def trainable_params(scene: Scene, groups=DEFAULT_GROUPS, camera=None) -> dict:
    """The differentiable leaves targeted by inverse rendering, keyed
    ``container.leaf`` (e.g. ``materials.albedo``, ``scene.tri_v0``,
    ``camera.translation``)."""
    out = {}
    for container, leaf in _group_leaves(groups):
        if container == "materials":
            out[f"materials.{leaf}"] = getattr(scene.materials, leaf)
        elif container == "scene":
            out[f"scene.{leaf}"] = getattr(scene, leaf)
        else:
            if camera is None:
                raise ValueError("camera group requires camera=...")
            out[f"camera.{leaf}"] = getattr(camera, leaf)
    return out


def apply_params(scene: Scene, params: dict) -> Scene:
    """Scene with the scene/material leaves in ``params`` substituted."""
    mat_kw = {k.split(".", 1)[1]: v for k, v in params.items()
              if k.startswith("materials.")}
    scn_kw = {k.split(".", 1)[1]: v for k, v in params.items()
              if k.startswith("scene.")}
    if mat_kw:
        scene = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, **mat_kw))
    if scn_kw:
        scene = dataclasses.replace(scene, **scn_kw)
    return scene


def apply_camera(camera, params: dict):
    cam_kw = {k.split(".", 1)[1]: v for k, v in params.items()
              if k.startswith("camera.")}
    return dataclasses.replace(camera, **cam_kw) if cam_kw else camera


@torch.no_grad()
def constrain_params(params: dict) -> dict:
    """Project updated parameters back to their physical domains, in
    place; returns ``params``."""
    if "materials.albedo" in params:
        params["materials.albedo"].clamp_(0.0, 1.0)
    if "materials.emission" in params:
        params["materials.emission"].clamp_(min=0.0)
    if "materials.ior" in params:
        params["materials.ior"].clamp_(1.0, 3.0)
    if "scene.sph_radius" in params:
        params["scene.sph_radius"].clamp_(min=1e-3)
    if "scene.pln_normal" in params:
        n = params["scene.pln_normal"]
        n.div_(torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-8))
    return params


def _make_fast_render(scene_tpl, camera_tpl, settings, cfg, mesh=None):
    """Image-valued render closure backed by the paired trace of
    ``ops.fast_grad`` (on the card: K1 with records forward, K2 backward;
    on a big mesh K1's hits-only records forward and the SoA replay
    backward).

    Returns ``render_fast(scene, camera, frame)``: f32[3, H, W], or with a
    mesh this rank's share f32[3, per] (its tile's pixel ids,
    ``sharded._padded_grid``, at its spp rank's salts; no collective).
    aa > 1 averages per-sample traces with the display path's AA_STRIDE
    salt layout, so the gradient is the mean of per-sample gradients."""
    from ..models.integrators import AA_STRIDE
    from ..ops.fast_grad import make_fast_kajiya
    from ..render import _INTEGRATOR_SITE, jittered_camera_rays

    spp = 0
    if mesh is not None:
        from ..parallel.sharded import _padded_grid, mesh_coords

        n_tiles, _, tile, spp = mesh_coords(mesh)
    trace = make_fast_kajiya(scene_tpl, _INTEGRATOR_SITE, settings.max_bounces,
                             style=settings.style)
    aa = settings.aa
    grid = {}

    def render_fast(s, cam, frame):
        if mesh is None:  # the whole film: the raster ids, no id tensor
            pixel, xs, ys = cfg.num_pixels, None, None
        else:
            dev = s.device
            if dev not in grid:  # this tile's pixel ids, once per device
                grid[dev] = _padded_grid(cfg, n_tiles, tile, dev)
            pixel, xs, ys = grid[dev]
        acc = 0.0
        for i in range(aa):
            salt_i = (i + spp * aa) * AA_STRIDE
            ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, frame, salt_i,
                                       divide=True, planes=True)
            acc = acc + trace(s, ray.origin, ray.direction, pixel, frame,
                              salt=salt_i)
        out = acc.T / aa
        return out if mesh is not None else out.reshape(3, cfg.height, cfg.width)

    return render_fast


def _fast_eligible(scene, settings: RenderSettings) -> bool:
    """The JAX rule (``_fast_eligible`` :191: every scene the kernels serve,
    ``render._megakernel_eligible``), and the paired trace differentiates
    Kajiya only, so every quadrant must be Kajiya.  ``make_fast_kajiya``
    picks the pullback by the scene: K2 up to 1,024 triangles, the SoA
    replay beyond them and on big meshes."""
    from ..models.integrators import KAJIYA
    from ..render import _megakernel_eligible

    return (set(settings.modes()) == {KAJIYA}
            and _megakernel_eligible(scene, settings))


def accumulate_frames(render, cfg: FilmConfig, params, frame0, k):
    """EMA-film accumulation of ``k`` sample frames, differentiable: the
    gradient of a loss on the result flows back through every one of the k
    samples (the EMA update of ops/film.py sits on the gradient path).

    ``render(params, frame) -> f32[3,H,W]`` (a rank's f32[3, per] slice
    under a mesh: the film takes the sample's shape); frames
    frame0..frame0+k-1 decorrelate the per-frame RNG streams.  A fresh film
    starts at frame 0, which the accumulate op itself treats as the dirty
    reset."""
    from ..ops import film as film_ops

    film = None
    for i in range(int(k)):
        sample = render(params, frame0 + i)
        if film is None:
            film = film_ops.Film(accum=torch.zeros_like(sample), frame=0)
        film = film_ops.accumulate(film, sample, False)
    return film.accum


def make_train_step(scene, camera, settings: RenderSettings, cfg: FilmConfig,
                    mesh, target, learning_rate: float = 2e-2, fast="auto",
                    groups=DEFAULT_GROUPS, accum_frames: int = 1):
    """Build (step fn, optimizer) for training.

    ``target`` is channels-first f32[3,H,W] (the film layout).  The
    optimizer is a ``torch.optim.Adam`` over copies of
    ``trainable_params(scene, groups, camera)``.  ``step(params, opt,
    frame) -> (params, opt, loss)``: ``params`` holds the values to step
    from (copied into the optimizer's tensors, so any dict of
    ``trainable_params`` keys works, as with the JAX step); the returned
    dict holds the optimizer's tensors, updated and constrained in place,
    and ``loss`` is a 0-d tensor on the device.  ``frame`` varies the RNG
    stream per step so Monte-Carlo noise decorrelates across steps.

    ``fast``: "auto" and True render through the paired trace of
    ``ops.fast_grad`` (where ``_fast_eligible``; True raises otherwise),
    False through autograd of the plain integrator path.  ``mesh``: None,
    or a ``(tiles, spp)`` ``DeviceMesh`` over which the step is sharded:
    each rank renders its tile's pixels at its spp rank's salts, the first
    buffer of the estimator is averaged over ``spp``, the residual on the
    rank's own pixels drives the backward of its second buffer (over the
    spp count), and the scene gradients are summed over every rank
    (``parallel.sharded.allreduce_grads``) before Adam, so every rank takes
    the same step and each gradient counts once; ``loss`` is the whole
    image's.  ``accum_frames`` > 1 targets the EMA-accumulated film after
    that many frames (``accumulate_frames``)."""
    if fast not in (True, False, "auto"):
        raise ValueError(f"fast must be True, False or 'auto', got {fast!r}")
    if mesh is not None:
        import torch.distributed as dist

        from ..parallel import sharded as sh
        from ..parallel.mesh import SPP_AXIS, TILE_AXIS
        from ..render import render_pixels

        n_tiles, n_spp, tile, spp = sh.mesh_coords(mesh)
    names = list(trainable_params(scene, groups, camera))
    live = {k: v.detach().clone().requires_grad_(True)
            for k, v in trainable_params(scene, groups, camera).items()}
    opt = torch.optim.Adam([live[k] for k in names], lr=learning_rate)

    eligible = _fast_eligible(scene, settings)
    if fast is True and not eligible:
        raise NotImplementedError(
            "the paired trace serves pure-Kajiya settings on scenes the "
            "kernels serve (render._megakernel_eligible)")
    use_fast = eligible if fast == "auto" else bool(fast)
    if use_fast:
        render_fast = _make_fast_render(scene, camera, settings, cfg, mesh)
    numel = target.numel()
    if mesh is not None:
        pixel, xs, ys = sh._padded_grid(cfg, n_tiles, tile, target.device)
        # Lanes past the film's last pixel (the last tile's padding).
        n_real = min(max(cfg.num_pixels - tile * pixel.shape[0], 0),
                     pixel.shape[0])
        target = target.reshape(3, -1)[:, pixel]

    def render(p, frame):
        s = apply_params(scene, p)
        cam = apply_camera(camera, p)
        if use_fast:
            return render_fast(s, cam, frame)
        if mesh is not None:
            return render_pixels(s, cam, settings, cfg, frame, pixel, xs, ys,
                                 aa_offset=spp * settings.aa).T
        return render_sample_chw(s, cam, settings, cfg, frame)

    k = max(int(accum_frames), 1)
    if k > 1:
        def render_used(p, frame0):
            return accumulate_frames(render, cfg, p, frame0, k)
    else:
        render_used = render

    def step(params, opt_state, frame):
        tensors = dict(zip(names, opt_state.param_groups[0]["params"]))
        with annotate("step.load"), torch.no_grad():
            for name, x in tensors.items():
                if params[name] is not x:
                    x.copy_(params[name])
        # Unbiased gradient of the squared error of the MEAN image via two
        # independent Monte-Carlo samples (the dual-buffer estimator):
        #   d/dp E[X-t]^2 = 2 E[X - t] * dE[X]/dp  ~  2 (X_a - t) . dX_b/dp
        # A single-sample gradient instead optimizes E[(X-t)^2], whose
        # variance term pulls emission down.  With accum_frames each buffer
        # is the k-frame EMA film; the two streams use disjoint frame ids.
        frame = int(frame)
        with annotate("step.render_a"), torch.no_grad():
            img_a = render_used(tensors, frame * (2 * k) + 4096)
            if mesh is not None and n_spp > 1:
                img_a = img_a.contiguous()
                dist.all_reduce(img_a, group=mesh.get_group(SPP_AXIS))
                img_a = img_a / n_spp
        with annotate("step.render_b"):
            img_b = render_used(tensors, frame * (2 * k) + 4096 + k)
        with annotate("step.backward"):
            diff = img_a - target
            opt_state.zero_grad(set_to_none=True)
            if mesh is None:
                img_b.backward(2.0 * diff / numel)
                loss = torch.mean(torch.square(img_a - target))
            else:
                diff[:, n_real:] = 0.0
                img_b.backward(2.0 * diff / numel / n_spp)
                sh.allreduce_grads(tensors.values())
                loss = diff.square().sum()
                if n_tiles > 1:
                    dist.all_reduce(loss, group=mesh.get_group(TILE_AXIS))
                loss = loss / numel
        with annotate("step.adam"):
            opt_state.step()
        with annotate("step.constrain"):
            constrain_params(tensors)
        return tensors, opt_state, loss

    return step, opt


def recover(scene_init, camera, settings, cfg, mesh, target, steps=100,
            learning_rate=2e-2, log_every=0, groups=DEFAULT_GROUPS,
            fast="auto", accum_frames: int = 1):
    """Run the optimization loop; returns (final scene, loss history as
    floats, final camera).  With the camera group the recovered pose is
    applied to the returned camera via ``apply_camera``."""
    step, opt = make_train_step(
        scene_init, camera, settings, cfg, mesh, target, learning_rate,
        fast=fast, groups=groups, accum_frames=accum_frames,
    )
    params = trainable_params(scene_init, groups, camera)
    losses = []
    for i in range(steps):
        params, opt, loss = step(params, opt, i)
        losses.append(loss.detach())
        if log_every and i % log_every == 0:
            print(f"step {i}: loss {float(loss):.6f}")
    final = {k: v.detach() for k, v in params.items()}
    return (apply_params(scene_init, final),
            [float(x) for x in torch.stack(losses).cpu()] if losses else [],
            apply_camera(camera, final))
