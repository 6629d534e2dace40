"""Multi-process runs of the sharded path: a launcher, the dry run and the
parity job (the port's counterpart of ``__graft_entry__.dryrun_multichip``).

``spawn`` starts one process per rank (spawned, so no state is inherited)
with a free localhost port for the rendezvous, waits for them with a
timeout and retries a port another process took first.  ``dryrun_multichip``
runs the sharded train step and frames on ``n`` gloo CPU processes.
``parity_job`` renders named cases sharded and unsharded on every rank and
saves both, so a caller holds them against each other (the CPU tests, and
``chip_smoke.py`` with two ranks on one card).  Workers import only the
port.
"""

from __future__ import annotations

import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import FilmConfig, RenderSettings
from ..ops import pathkernel as pk
from ..render import (_pixel_grid, _sample_mode, _tracer_and_camera, render_pixels,
                      render_sample_chw, render_sample_fast_chw)
from ..scene import builtin
from ..train import inverse
from . import sharded as sh
from .distributed import gather_film_to_host, initialize_distributed
from .mesh import SPP_AXIS, TILE_AXIS, make_mesh

# Each case of parity_job: (name, (n_tiles, n_spp), (width, height)).
# Single-mode fast cases are "fast_<mode>"; "fast_split" is AO, Whitted,
# Hart, Kajiya (the split-screen of the JAX dry run: 3, 9, 0, 7).
SPLIT = (3, 9, 0, 7)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, args=(), timeout: float = 300.0, attempts: int = 3):
    """Run ``fn(rank, world, port, *args)`` in ``world`` spawned processes
    (``fn`` importable by name); ``port`` is a free localhost port for rank
    0's rendezvous.  Raises if a process fails or the job outlives
    ``timeout`` seconds (every process is then killed); a port that another
    process bound first is retried with a new one."""
    from torch.multiprocessing import ProcessRaisedException, start_processes

    for attempt in range(attempts):
        ctx = start_processes(fn, args=(world, free_port(), *args), nprocs=world,
                              join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__} x{world} outlived {timeout} s")
            return
        except ProcessRaisedException as e:
            if attempt + 1 == attempts or "address already in use" not in str(e).lower():
                raise
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


def _join(rank, world, port, device, backend=None):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # several ranks share the host's cores
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device=device,
                           backend=backend)


def _scene(name, cfg, dev):
    if name == "cornell":
        return builtin.cornell_box(aspect=cfg.aspect, device=dev)
    if name == "sphere":
        return builtin.sphere_plane(aspect=cfg.aspect, device=dev)
    return builtin.mesh_demo(int(name[len("mesh"):]), aspect=cfg.aspect, device=dev)


def _settings(bounces, mode):
    modes = SPLIT if mode == "split" else (int(mode),) * 4
    return RenderSettings(max_bounces=bounces, style="standard",
                          top_left_render_mode=modes[0], top_right_render_mode=modes[1],
                          bottom_left_render_mode=modes[2],
                          bottom_right_render_mode=modes[3])


def _spp_mean(n_spp, sample):
    """The mean of ``sample(aa_offset)`` over the spp ranks' AA offsets."""
    acc = None
    for k in range(n_spp):
        s = sample(k)
        acc = s if acc is None else acc + s
    return acc / n_spp


def _train(scene, cam, settings, cfg, mesh, fast):
    """One train step over albedo and emission from perturbed values
    toward the true scene's plain render -> (params, loss)."""
    target = render_sample_chw(scene, cam, settings, cfg, 0)
    init = inverse.apply_params(scene, {
        "materials.albedo": torch.full_like(scene.materials.albedo, 0.5),
        "materials.emission": scene.materials.emission * 0.25})
    step, opt = inverse.make_train_step(init, cam, settings, cfg, mesh, target,
                                        learning_rate=3e-2, fast=fast)
    params, _, loss = step(inverse.trainable_params(init), opt, 0)
    return {k: v.detach() for k, v in params.items()}, loss.detach()


def collectives_ms(mesh, n: int, device, reps: int = 5):
    """(frame, step) ms of the sharded path's collectives on ``mesh`` for
    an n-pixel film, host clock around a synchronized run, mean of
    ``reps`` after one: a frame's ``sharded.combine`` of f32[3, per], and
    a step's spp mean of its first buffer, gradient sum (2 x f32[6, 3],
    albedo and emission of the Cornell box) and loss sum (each only where
    its axis has more than one rank, as in ``make_train_step``)."""
    n_tiles, n_spp, _, _ = sh.mesh_coords(mesh)
    per = -(-n // n_tiles)
    x = torch.rand((3, per), device=device)
    params = [torch.zeros((6, 3), device=device, requires_grad=True) for _ in range(2)]
    for t in params:
        t.grad = torch.ones_like(t)
    loss = torch.zeros((), device=device)

    def step():
        if n_spp > 1:
            dist.all_reduce(x.clone(), group=mesh.get_group(SPP_AXIS))
        sh.allreduce_grads(params)
        if n_tiles > 1:
            dist.all_reduce(loss, group=mesh.get_group(TILE_AXIS))

    out = []
    for fn in (lambda: sh.combine(x, mesh, n), step):
        fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / reps * 1e3)
    return tuple(out)


def _case(name, mesh, cfg, bounces, dev, ref):
    """(sharded results, unsharded references if ``ref``) of one case."""
    n_spp = mesh.shape[1]
    if name == "collectives":
        frame_ms, step_ms = collectives_ms(mesh, cfg.num_pixels, dev)
        return {"got.frame_ms": torch.tensor(frame_ms), "got.step_ms": torch.tensor(step_ms)}
    if name == "gather":
        # Each rank renders its slice of the film's ids (frame 1, the
        # plain path); rank 0 assembles the film.
        scene, cam = _scene("cornell", cfg, dev)
        pixel, xs, ys = sh._padded_grid(cfg, dist.get_world_size(),
                                        dist.get_rank(), dev)
        local = render_pixels(scene, cam, _settings(bounces, 9), cfg, 1, pixel,
                              xs, ys)
        ranks = [torch.empty(1, dtype=torch.int64, device=dev)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(ranks, torch.tensor([dist.get_rank()], device=dev))
        full = gather_film_to_host(local)
        out = {"got.ranks": torch.cat(ranks)}
        if full is not None:
            out["got.film"] = torch.from_numpy(full)
        return out
    if name.startswith("train_"):
        route, scene_name = name.split("_")[1:]
        scene, cam = _scene(scene_name, cfg, dev)
        st = _settings(bounces, 9)
        got, loss = _train(scene, cam, st, cfg, mesh, route == "fast")
        out = {f"got.{k}": v for k, v in got.items()} | {"got.loss": loss}
        if ref:
            want, loss = _train(scene, cam, st, cfg, None, route == "fast")
            out |= {f"want.{k}": v for k, v in want.items()} | {"want.loss": loss}
        return out
    if name.startswith("grad_"):
        scene, cam = _scene(name[len("grad_"):], cfg, dev)
        st = _settings(bounces, 9)
        albedo = scene.materials.albedo.clone().requires_grad_(True)
        sc = inverse.apply_params(scene, {"materials.albedo": albedo})
        img = sh.render_sample_sharded(sc, cam, st, cfg, 0, mesh)
        img.mean().backward()
        sh.allreduce_grads([albedo])
        out = {"got.image": img.detach(), "got.grad": albedo.grad}
        if ref:
            a = scene.materials.albedo.clone().requires_grad_(True)
            render_sample_chw(inverse.apply_params(scene, {"materials.albedo": a}), cam, st,
                              cfg, 0).mean().backward()
            out["want.grad"] = a.grad
        return out
    route, mode, scene_name = name.split("_")
    scene, cam = _scene(scene_name, cfg, dev)
    st = _settings(bounces, mode)
    before = pk.launch_path_kernel.launches
    if route == "plain":
        got = sh.render_sample_sharded(scene, cam, st, cfg, 0, mesh)
    else:
        got = sh.render_sample_sharded_fast(scene, cam, st, cfg, 0, mesh)
    out = {"got.image": got,
           "got.k1_launches": torch.tensor(pk.launch_path_kernel.launches - before)}
    if not ref:
        return out
    if n_spp == 1:
        want = (render_sample_chw if route == "plain" else
                render_sample_fast_chw)(scene, cam, st, cfg, 0)
    elif route == "plain":
        pixel, xs, ys = _pixel_grid(cfg, dev)
        want = _spp_mean(n_spp, lambda k: render_pixels(
            scene, cam, st, cfg, 0, pixel, xs, ys, aa_offset=k * st.aa).T)
    else:
        pt, cp = _tracer_and_camera(scene, cam, cfg, None, None)
        ids = torch.arange(cfg.num_pixels, device=dev)
        want = _spp_mean(n_spp, lambda k: _sample_mode(
            pt, cam, st, cfg, cp, ids, 0, int(mode), aa_offset=k * st.aa))
    out["want.image"] = want.reshape(3, cfg.height, cfg.width)
    return out


def parity_job(rank, world, port, out_dir, cases, device="cpu", backend=None,
               bounces=2):
    """Worker: join the group, run each ``(name, (n_tiles, n_spp),
    (width, height))`` of ``cases`` and save ``out_dir/rank<r>.npz`` with
    ``<name>.got.<key>`` (every rank) and ``<name>.want.<key>`` (the
    unsharded reference, rank 0).  Names: ``plain_<mode>_<scene>``,
    ``fast_<mode>_<scene>`` (mode an integrator id or ``split``; scene
    ``cornell``, ``sphere`` or ``mesh<subdiv>``), ``grad_<scene>`` (the
    sharded plain image and its mean's albedo gradient, summed over the
    ranks), ``train_fast_<scene>`` and ``train_plain_<scene>`` (one train
    step's parameters and loss), ``gather`` (each rank's slice of a plain
    frame assembled by ``gather_film_to_host``, and every rank's id through
    ``all_gather``), ``collectives`` (``collectives_ms``).  Each mesh's
    dims, shape and this rank's coordinates go under ``mesh@<shape>``."""
    _join(rank, world, port, device, backend)
    try:
        meshes, saved = {}, {}
        for name, shape, (w, h) in cases:
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape, device=device)
                m = meshes[shape]
                saved[f"mesh@{shape[0]}x{shape[1]}.coords"] = np.array(
                    [m.get_local_rank(n) for n in m.mesh_dim_names])
                saved[f"mesh@{shape[0]}x{shape[1]}.names"] = np.array(m.mesh_dim_names)
                saved[f"mesh@{shape[0]}x{shape[1]}.shape"] = np.array(m.shape)
            t0 = time.perf_counter()
            res = _case(name, meshes[shape], FilmConfig(w, h), bounces,
                        torch.device(device), rank == 0)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            res["got.seconds"] = torch.tensor(time.perf_counter() - t0)
            key = f"{name}@{shape[0]}x{shape[1]}@{w}x{h}"
            saved |= {f"{key}.{k}": v.detach().cpu().numpy() for k, v in res.items()}
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    finally:
        dist.destroy_process_group()


def _dryrun_worker(rank, world, port):
    _join(rank, world, port, "cpu")
    try:
        n_spp = 2 if world % 2 == 0 else 1
        mesh = make_mesh(world // n_spp, n_spp, device="cpu")
        cfg = FilmConfig(width=32, height=16)
        scene, cam = _scene("cornell", cfg, "cpu")
        _, loss = _train(scene, cam, _settings(2, 9), cfg, mesh, "auto")
        if not torch.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss}")
        lines = [f"dryrun_multichip({world}): mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                 f"loss={float(loss):.5f}"]
        for label, scene_name, mode in (("kernel-route Cornell", "cornell", 9),
                                        ("split-screen", "cornell", "split"),
                                        ("big-mesh mesh_demo(3)", "mesh3", 9)):
            scene, cam = _scene(scene_name, cfg, "cpu")
            img = sh.render_sample_sharded_fast(scene, cam, _settings(2, mode), cfg, 0,
                                                mesh)
            if img.shape != (3, cfg.height, cfg.width) or not torch.isfinite(img).all():
                raise RuntimeError(f"{label} frame: shape {tuple(img.shape)} or non-finite")
            lines.append(f"dryrun_multichip({world}): {label} shard ok")
        if rank == 0:
            print("\n".join(lines), flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> None:
    """One sharded train step, one kernel-route Cornell frame, one
    split-screen frame (AO, Whitted, Hart, Kajiya) and one frame of a big
    mesh (``mesh_demo(3)``, 1,282 triangles, ``BigMeshTracer``) on a
    ``(n/2, 2)`` mesh (``(n, 1)`` for odd n) of ``n_devices`` gloo CPU
    processes, 32x16, 2 bounces; raises if any rank fails or an output is
    not finite."""
    spawn(_dryrun_worker, n_devices, timeout=timeout)
