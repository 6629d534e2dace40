"""Sharded rendering over a ``(tiles, spp)`` device mesh (mirror of
``rvpt_tpu/parallel/sharded.py``), one process per device.

* Film pixels are data parallel over ``tiles``: tile rank t renders the
  contiguous raster ids ``[t * per, (t + 1) * per)``, ``per = ceil(N /
  n_tiles)`` (ids past N wrap to the film's first pixels and are dropped
  after the gather), a band of whole film rows.  The scene is replicated,
  so tracing needs no traffic between devices.
* ``spp`` ranks render the same pixels with decorrelated salts (spp rank s
  takes the AA sample indices ``s * aa ..``, the JAX layout) and their
  samples are averaged.
* The combine is two collectives: an ``all_reduce`` over ``spp`` divided
  by its size, then an ``all_gather`` over ``tiles``.  Every rank then
  holds the whole image, as JAX's global array.  An axis of one rank
  needs no collective and runs none (as JAX's pmean over one spp rank).

RNG streams are keyed by the global pixel id, so with one spp rank the
sharded image is the unsharded one bit for bit.

Gradients follow PyTorch's data-parallel idiom, not JAX's transposed
collectives: the combine's backward hands each rank its own pixels' share
of the image cotangent (every rank holds the same loss), so a rank's
scene gradient covers its own pixels and samples, and ``allreduce_grads``
(a SUM over every rank) makes the gradient of the whole image.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import FilmConfig, RenderSettings
from ..ops import film as film_ops
from ..render import (_megakernel_eligible, _rect_pixels, _sample_mode,
                      _split_partition, _tracer_and_camera, render_pixels)
from .mesh import SPP_AXIS, TILE_AXIS


def mesh_coords(mesh) -> tuple[int, int, int, int]:
    """(n_tiles, n_spp, tile rank, spp rank) of this process on ``mesh``,
    a ``(tiles, spp)`` ``DeviceMesh`` over every rank of the group."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (parallel.mesh."
                        f"make_mesh), got {type(mesh).__name__}")
    if tuple(mesh.mesh_dim_names or ()) != (TILE_AXIS, SPP_AXIS):
        raise ValueError(f"mesh dims must be {(TILE_AXIS, SPP_AXIS)}, got "
                         f"{mesh.mesh_dim_names}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh covers {mesh.size()} of "
                         f"{dist.get_world_size()} ranks")
    n_tiles, n_spp = mesh.shape
    return (n_tiles, n_spp, mesh.get_local_rank(TILE_AXIS),
            mesh.get_local_rank(SPP_AXIS))


def _tile_ids(ids: torch.Tensor, n_tiles: int, tile: int) -> torch.Tensor:
    """Tile rank ``tile``'s ``ceil(n / n_tiles)`` entries of ``ids``,
    padded by wrapping to its first entries."""
    n = ids.shape[0]
    per = -(-n // n_tiles)
    lo = tile * per
    if lo + per <= n:
        return ids[lo:lo + per]
    return ids[torch.arange(lo, lo + per, device=ids.device) % n]


def _padded_grid(cfg: FilmConfig, n_tiles: int, tile: int, device):
    """This tile rank's raster pixel ids int64[per] and their integer
    coordinates (``render._pixel_grid``'s, sliced)."""
    pixel = _tile_ids(torch.arange(cfg.num_pixels, dtype=torch.int64,
                                   device=device), n_tiles, tile)
    return pixel, pixel % cfg.width, torch.div(pixel, cfg.width,
                                               rounding_mode="floor")


class _Combine(torch.autograd.Function):
    """Forward: the spp mean of this rank's f32[3, per] slice, then the
    slices of every tile gathered -> f32[3, n_tiles * per] (on a mesh of
    more than one rank).  Backward: this rank's slice of the cotangent
    over n_spp."""

    @staticmethod
    def forward(ctx, local, mesh):
        n_tiles, n_spp, tile, _ = mesh_coords(mesh)
        x = local.detach().contiguous()
        if n_spp > 1:
            x = x.clone()
            dist.all_reduce(x, group=mesh.get_group(SPP_AXIS))
            x = x / n_spp
        ctx.slice = (tile * x.shape[1], (tile + 1) * x.shape[1], n_spp)
        if n_tiles == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(n_tiles)]
        dist.all_gather(parts, x, group=mesh.get_group(TILE_AXIS))
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        lo, hi, n_spp = ctx.slice
        return g[:, lo:hi] / n_spp, None


def combine(local: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """Every rank's f32[3, per] slices of an n-pixel batch, spp-averaged and
    gathered -> f32[3, n] on every rank (``local`` itself on one rank)."""
    if mesh.size() == 1:
        return local[:, :n]
    return _Combine.apply(local, mesh)[:, :n]


def allreduce_grads(tensors) -> None:
    """Sum the ``.grad`` of ``tensors`` over every rank, in place, in one
    collective (none on one rank): each rank's share of a gradient through
    ``combine`` becomes the whole image's."""
    grads = [t.grad for t in tensors if t.grad is not None]
    if not grads or dist.get_world_size() == 1:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def render_sample_sharded(scene, camera, settings: RenderSettings,
                          cfg: FilmConfig, frame, mesh):
    """Full-film sample image f32[3,H,W] rendered across the mesh through
    the plain integrator path (``render.render_pixels``); every rank holds
    it.  Effective samples per pixel = settings.aa * mesh.shape[spp]."""
    n_tiles, _, tile, spp = mesh_coords(mesh)
    pixel, xs, ys = _padded_grid(cfg, n_tiles, tile, scene.device)
    local = render_pixels(scene, camera, settings, cfg, frame, pixel, xs, ys,
                          aa_offset=spp * settings.aa)
    return combine(local.T, mesh, cfg.num_pixels).reshape(
        3, cfg.height, cfg.width)


def render_sample_sharded_fast(scene, camera, settings: RenderSettings,
                               cfg: FilmConfig, frame, mesh, tracer=None,
                               cam_params=None):
    """Sample image f32[3,H,W] across the mesh through the kernels
    (``render.render_sample_fast_chw``'s route per shard): any integrator
    mode, the 4-way split-screen (each quadrant's pixel ids sharded over
    the whole mesh in turn and written into its rectangle), any scene the
    kernels serve, big meshes included.  ``tracer`` and ``cam_params`` as
    in ``render_sample_fast_chw``."""
    n_tiles, _, tile, spp = mesh_coords(mesh)
    pt, cam_params = _tracer_and_camera(scene, camera, cfg, tracer, cam_params)

    def sharded(ids, mode):
        local = _sample_mode(pt, camera, settings, cfg, cam_params,
                             _tile_ids(ids, n_tiles, tile), frame, mode,
                             aa_offset=spp * settings.aa)
        return combine(local, mesh, ids.shape[0])

    modes = set(settings.modes())
    if len(modes) == 1:
        (mode,) = modes
        ids = torch.arange(cfg.num_pixels, dtype=torch.int64, device=scene.device)
        return sharded(ids, mode).reshape(3, cfg.height, cfg.width)
    out = torch.empty((3, cfg.height, cfg.width), dtype=torch.float32,
                      device=scene.device)
    for m, (y0, y1, x0, x1) in _split_partition(cfg, settings):
        ids = _rect_pixels(y0, y1, x0, x1, cfg.width, scene.device)
        out[:, y0:y1, x0:x1] = sharded(ids, m).reshape(3, y1 - y0, x1 - x0)
    return out


def _sharded_fast_eligible(scene, settings: RenderSettings) -> bool:
    """The sharded frame takes the kernels wherever the unsharded display
    path does (``render._megakernel_eligible``)."""
    return _megakernel_eligible(scene, settings)


def render_frame_sharded(scene, camera, settings, cfg, film, dirty, mesh,
                         tracer=None, cam_params=None):
    """Sharded sample + EMA -> (new_film, image f32[3,H,W]); every rank
    holds the whole film.  Frames the kernels serve take
    ``render_sample_sharded_fast``, the rest the plain path."""
    frame = 0 if dirty else int(film.frame)
    if _sharded_fast_eligible(scene, settings):
        sample = render_sample_sharded_fast(scene, camera, settings, cfg,
                                            frame, mesh, tracer, cam_params)
    else:
        sample = render_sample_sharded(scene, camera, settings, cfg, frame,
                                       mesh)
    new_film = film_ops.accumulate(film, sample, dirty)
    return new_film, new_film.accum


def make_render_fn(scene, camera, settings, cfg, mesh):
    """The steady-state sharded frame step ``step(scene, camera, film,
    dirty, tracer=None, cam_params=None) -> (film, image)`` (a plain
    closure: nothing to compile)."""
    mesh_coords(mesh)

    def step(scene, camera, film, dirty, tracer=None, cam_params=None):
        return render_frame_sharded(scene, camera, settings, cfg, film, dirty,
                                    mesh, tracer, cam_params)

    return step
