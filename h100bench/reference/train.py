"""Plain PyTorch reference of the trainer's first steps, and the comparison
that decides a training cell's ``correct``.

The step is frozen from rvpt_tpu_torch/train/inverse.py:262-297 (the
dual-buffer estimator: the first render without a gradient at frame
2i + 4096, the second differentiated at 2i + 4097 and pulled back with
2 (first - target) / size), :88-104 (constrain_params) and PyTorch's Adam
with its defaults (b1 0.9, b2 0.999, eps 1e-8), written out here.  The
renders are ``kajiya.trace`` over the whole film in blocks of rays, with
autograd for the gradient.  Nothing here imports the port.
"""

from __future__ import annotations

import math
import statistics

import torch

from . import kajiya as ref

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
# Trained group -> the reference scene's leaves.
GROUP_LEAVES = {"albedo": ("albedo",), "emission": ("emission",),
                "vertices": ("v0", "v1", "v2")}
# The port's parameter names -> the reference's leaves.
PORT_NAMES = {"materials.albedo": "albedo", "materials.emission": "emission",
              "scene.tri_v0": "v0", "scene.tri_v1": "v1", "scene.tri_v2": "v2"}


def perturb(scene: ref.Scene, groups, g: torch.Generator, vertex_sigma: float):
    """The trainer's start: each trained material value scaled by a factor
    in [0.5, 1.5] (albedo clamped to [0, 1]), each distinct vertex moved by
    a normal draw of ``vertex_sigma`` per axis (a shared corner moves
    once, so the mesh stays closed)."""
    dev = scene.device

    def scale(x):
        return x * (0.5 + torch.rand(x.shape, generator=g, device=dev))

    kw = {}
    if "albedo" in groups:
        kw["albedo"] = torch.clamp(scale(scene.albedo), 0.0, 1.0)
    if "emission" in groups:
        kw["emission"] = scale(scene.emission)
    if "vertices" in groups:
        corners = torch.cat([scene.v0, scene.v1, scene.v2])
        uniq, inv = torch.unique(corners, dim=0, return_inverse=True)
        moved = uniq + vertex_sigma * torch.randn(uniq.shape, generator=g, device=dev)
        v0, v1, v2 = moved[inv].chunk(3)
        kw.update(v0=v0.contiguous(), v1=v1.contiguous(), v2=v2.contiguous())
    return scene.replace(**kw)


def display_rays(scene: ref.Scene, width, height, pix, frame, dtype):
    """The rays of the program's display path for this scene: made in the
    kernel, or in PyTorch on a big mesh."""
    if scene.big_mesh():
        return ref.torch_rays(scene, width, height, pix, frame, dtype=dtype)
    return ref.kernel_rays(ref.camera_vector(scene, width, height), pix, frame,
                           dtype=dtype)


def render(scene, tab, rays_fn, pix, frame, cfg, cotangent=None):
    """The image [3, N] over ``pix`` in blocks; with ``cotangent`` [3, N],
    also pulls it back into the scene's leaves that require a gradient."""
    out = []
    for i in range(0, pix.shape[0], ref.RAY_CHUNK):
        p = pix[i:i + ref.RAY_CHUNK]
        with torch.set_grad_enabled(cotangent is not None):
            img = ref.trace(scene, tab, rays_fn(p, frame), p, frame,
                            ref.INTEGRATOR_SITE, cfg["bounces"], cfg["style"],
                            tris_last=scene.bvh)
            if cotangent is not None:
                (img.float() * cotangent[:, i:i + ref.RAY_CHUNK]).sum().backward()
        out.append(img.detach().float())
    return torch.cat(out, dim=1)


def follow(true: ref.Scene, init: ref.Scene, cfg: dict, traffic: dict, film,
           target_frame: int, dtype=torch.float32) -> dict:
    """The reference's first ``check_steps`` steps from ``init`` toward the
    true scene's frame -> {"losses", "grad1", "delta"} (norms by leaf)."""
    width, height = film
    n = width * height
    pix = torch.arange(n, device=true.device)
    target = render(true, ref.Tables(true, dtype),
                    lambda p, f: display_rays(true, width, height, p, f, dtype),
                    pix, target_frame, cfg)
    leaves = [leaf for g in traffic["groups"] for leaf in GROUP_LEAVES[g]]
    params = {k: getattr(init, k).detach().clone().requires_grad_(True) for k in leaves}
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    lr = float(traffic["learning_rate"])
    losses, grad1 = [], None
    for i in range(int(traffic["check_steps"])):
        scene = init.replace(**params)
        tab = ref.Tables(scene, dtype)

        def rays(p, f):
            return ref.torch_rays(scene, width, height, p, f, divide=True, dtype=dtype)

        img_a = render(scene, tab, rays, pix, 2 * i + 4096, cfg)
        diff = img_a - target
        losses.append(float(torch.mean(diff.double() ** 2)))
        for p in params.values():
            p.grad = None
        render(scene, tab, rays, pix, 2 * i + 4097, cfg, cotangent=2.0 * diff / diff.numel())
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if i == 0:
            grad1 = by_leaf(grads)
        with torch.no_grad():
            t = i + 1
            for k, p in params.items():
                m[k].mul_(BETA1).add_(grads[k], alpha=1 - BETA1)
                v2[k].mul_(BETA2).addcmul_(grads[k], grads[k], value=1 - BETA2)
                denom = (v2[k].sqrt() / math.sqrt(1 - BETA2 ** t)).add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-lr / (1 - BETA1 ** t))
            if "albedo" in params:
                params["albedo"].clamp_(0.0, 1.0)
            if "emission" in params:
                params["emission"].clamp_(min=0.0)
    delta = by_leaf({k: params[k].detach() - start[k] for k in params})
    return {"losses": losses, "grad1": grad1, "delta": delta}


def by_leaf(tensors: dict) -> dict:
    """Norm of each leaf (float64), keyed by the reference's leaf names."""
    return {PORT_NAMES.get(k, k): float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def leaf_gap(got: dict, want: dict, kept) -> float:
    """The worst leaf's gap between the two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(want[k] for k in kept)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in kept)


def compare(got: dict, want: dict) -> dict:
    """{"loss_gap", "grad_gap", "delta_gap"}: the largest relative gap of a
    step's loss, and the worst leaf's of the first gradient and of the
    change.  Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of both."""
    med = statistics.median(want["grad1"].values())
    kept = [k for k, g in want["grad1"].items() if g >= 1e-3 * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(got["grad1"], want["grad1"], kept),
            "delta_gap": leaf_gap(got["delta"], want["delta"], kept)}
