"""BRDF sampling and the shared bounce-shading step (mirror of
``rvpt_tpu/models/brdf.py``).

All three material branches (Lambert, mirror, dielectric with a stochastic
Fresnel choice) are evaluated for every lane and combined with ``where``,
as in the reference's material switch (integrators.glsl:584-668).
"""

from __future__ import annotations

import torch

from ..core.math import INV_PI, PI, vdot
from ..core.sampling import map_cosine_hemisphere_simple
from ..scene.materials import DIELECTRIC, LAMBERT, MIRROR

EPSILON = 5e-3  # surface offset, reference: compute_pass.comp:9


def fresnel_reflectance(cos_in, cos_out, eta):
    """Unpolarized Fresnel reflectance (material.glsl:207-228)."""
    r_perp = (eta * cos_in - cos_out) / (eta * cos_in + cos_out)
    r_par = (cos_in - eta * cos_out) / (cos_in + eta * cos_out)
    return 0.5 * (r_perp * r_perp + r_par * r_par)


def flip_normal_eta(dir_in, normal, ior):
    """Orient the normal against the incident ray and compute the relative
    index of refraction (integrators.glsl:591-612).  ``dir_in`` must be
    normalized.  Returns (normal, cos_in >= 0, eta = outside/inside)."""
    cos_view = vdot(dir_in, normal)
    flipped = cos_view > 0.0
    cos_in = torch.abs(cos_view)
    normal = torch.where(flipped[..., None], -normal, normal)
    eta = torch.where(flipped, ior, 1.0 / torch.clamp(ior, min=1e-8))
    return normal, cos_in, eta


def shade_and_scatter(pos, normal, dir_in, mat, rnd_u, rnd_v, rnd_fresnel):
    """One bounce of the shared material switch (integrators.glsl:614-668).

    ``pos``/``normal``/``dir_in`` are f32[N,3] (normal normalized, pre-flip;
    dir_in normalized); ``mat`` the gathered ``Materials`` rows; the three
    uniforms f32[N].  Returns (pos_out, dir_out, throughput_factor) for
    every lane; the caller masks by hit validity.
    """
    normal, cos_in, eta = flip_normal_eta(dir_in, normal, mat.ior)

    # Lambert (type 0): cosine-weighted scatter, factor = albedo.
    lam_pos = pos + EPSILON * normal
    lam_dir = map_cosine_hemisphere_simple(rnd_u, rnd_v, normal)
    lam_fac = (mat.albedo * INV_PI) * PI

    # Mirror (type 1): deterministic reflection, factor = albedo.
    refl_dir = dir_in + (2.0 * cos_in)[..., None] * normal
    mir_pos = pos + EPSILON * normal
    mir_fac = mat.albedo

    # Dielectric (type 2): stochastic Fresnel reflect/refract.
    cos_out_sqr = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
    cos_out = torch.sqrt(torch.clamp(cos_out_sqr, min=1e-12))
    f_refl = fresnel_reflectance(cos_in, cos_out, eta)
    reflect_mask = (cos_out_sqr <= 0.0) | (rnd_fresnel < f_refl)
    refr_dir = eta[..., None] * dir_in + (eta * cos_in - cos_out)[..., None] * normal
    die_pos = torch.where(
        reflect_mask[..., None], pos + EPSILON * normal, pos - EPSILON * normal
    )
    die_dir = torch.where(reflect_mask[..., None], refl_dir, refr_dir)
    die_fac = mat.albedo

    is_lam = (mat.kind == LAMBERT)[..., None]
    is_mir = (mat.kind == MIRROR)[..., None]
    is_die = (mat.kind == DIELECTRIC)[..., None]

    pos_out = torch.where(is_lam, lam_pos, torch.where(is_mir, mir_pos, die_pos))
    dir_out = torch.where(is_lam, lam_dir, torch.where(is_mir, refl_dir, die_dir))
    fac = torch.where(
        is_lam, lam_fac,
        torch.where(is_mir, mir_fac,
                    torch.where(is_die, die_fac, torch.zeros_like(die_fac))),
    )
    return pos_out, dir_out, fac
