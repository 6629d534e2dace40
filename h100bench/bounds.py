"""Roofline arithmetic of the kernels, frozen from chip_smoke.py:265-345 and
:1135-1166, :1330-1341: the least time the card could take for a launch's
work, the larger of its bytes over the memory rate and its operations
over the FP32 rate.  The work is what the algorithm needs on the run's
inputs, counted by the reference's census (``reference.kajiya.trace``),
not by the kernel."""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet, dense, at the 700 W limit): FP32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# K1, per ray-bounce: a metric-tensor triangle test 53, a sphere test 40,
# a plane test 15; the Kajiya shading of a hit 120 and its PCG3D draw 33;
# a lane that ends 9; per camera ray made in the kernel 69.
OPS_TRI, OPS_SPH, OPS_PLN = 53, 40, 15
OPS_SHADE, OPS_PCG, OPS_END, OPS_CAMERA = 120, 33, 9, 69
# K2, per slot of the record by kind, and per hit and per dielectric hit.
OPS_BWD = {"dead": 1, "miss": 28, "tri": 33 + 89, "sph": 46 + 87, "pln": 16 + 46}
OPS_BWD_HIT, OPS_BWD_GLASS = 44 + 93 + 16, 96


def bound_s(bytes_moved: float, ops: float) -> float:
    """Seconds at the card's peak: the larger of the two bounds."""
    return max(bytes_moved / PEAK_BYTES, ops / PEAK_FP32)


def k1_bound_s(census: dict, counts) -> float:
    """K1 on one frame with its camera rays made in the kernel: every
    search over the scene's triangles, spheres and planes (``counts``),
    the shading and draw of every hit that scatters, the lanes that end;
    bytes the f32[3] film per ray."""
    t, s, p = counts
    ops = (census["search"] * (t * OPS_TRI + s * OPS_SPH + p * OPS_PLN)
           + census["scatter"] * (OPS_SHADE + OPS_PCG) + census["end"] * OPS_END
           + census["rays"] * OPS_CAMERA)
    return bound_s(12 * census["rays"], ops)


def k2_bound_s(census: dict) -> float:
    """K2 on one record: 48 B per live ray-bounce, 4 per dead slot, 44 per
    ray (g, pixel id, the o/d cotangents); operations by kind of slot."""
    n, nb, live = census["rays"], census["bounces"], census["search"]
    dead = n * nb - live
    hits = census["tri"] + census["sph"] + census["pln"]
    ops = (dead * OPS_BWD["dead"] + census["end"] * OPS_BWD["miss"]
           + sum(census[k] * OPS_BWD[k] for k in ("tri", "sph", "pln"))
           + hits * OPS_BWD_HIT + census["glass"] * OPS_BWD_GLASS)
    return bound_s(live * 48 + dead * 4 + n * 44, ops)
