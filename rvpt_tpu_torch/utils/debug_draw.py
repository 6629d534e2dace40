"""Host-side debug visualization (mirror of ``rvpt_tpu/utils/debug_draw.py``).

The reference's debug raster pipelines draw the scene triangles as
wireframe overlays and the BVH as per-depth AABB line lists
(src/rvpt/rvpt.cpp:128-236, 966-994, assets/shaders/debug_vis.*).  Here a
NumPy line rasterizer draws the same data on the host: project with the
port's ``Camera``, Bresenham the edges into the rendered frame.
"""

from __future__ import annotations

import numpy as np

from ..models.camera import Camera, camera_matrix


def _project(points: np.ndarray, cam: Camera, width: int, height: int):
    """World -> pixel coordinates under the pinhole model (inverse of
    camera.glsl:29-51).  Returns (xy i32[N,2], in_front bool[N])."""
    m = camera_matrix(cam).detach().cpu().numpy()
    r = m[:3, :3]
    t = m[:3, 3]
    local = (points - t) @ r  # R^T (p - t)
    w = 1.0 / np.tan(0.5 * np.radians(float(cam.fov.item())))
    z = local[:, 2]
    in_front = z > 1e-6
    zs = np.where(in_front, z, 1.0)
    u = local[:, 0] * w / zs / cam.aspect  # u in [-1,1]
    v = local[:, 1] * w / zs
    x = (u + 1.0) * 0.5 * width
    y = (1.0 - (v + 1.0) * 0.5) * height  # y flip like the film
    return np.stack([x, y], axis=-1), in_front


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Bresenham line into img[H,W,3] (clipped)."""
    h, w = img.shape[:2]
    x0, y0 = int(round(p0[0])), int(round(p0[1]))
    x1, y1 = int(round(p1[0])), int(round(p1[1]))
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    # crude clip: skip entirely-offscreen segments
    if max(x0, x1) < 0 or min(x0, x1) >= w or max(y0, y1) < 0 or min(y0, y1) >= h:
        return
    guard = 4 * (abs(x1 - x0) + abs(y1 - y0) + 1)
    while guard > 0:
        guard -= 1
        if 0 <= x0 < w and 0 <= y0 < h:
            img[y0, x0] = color
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


_EDGES_AABB = [
    (0, 1), (1, 3), (3, 2), (2, 0),  # bottom
    (4, 5), (5, 7), (7, 6), (6, 4),  # top
    (0, 4), (1, 5), (2, 6), (3, 7),  # pillars
]


def overlay_triangles(img: np.ndarray, scene, cam: Camera,
                      color=(1.0, 0.0, 0.0)) -> np.ndarray:
    """Wireframe of every scene triangle over a rendered frame — the analog
    of the reference's debug raster overlay (rvpt.cpp:128-150, 966-980)."""
    img = np.array(img, np.float32, copy=True)
    h, w = img.shape[:2]
    v0 = scene.tri_v0.detach().cpu().numpy()
    v1 = scene.tri_v1.detach().cpu().numpy()
    v2 = scene.tri_v2.detach().cpu().numpy()
    if len(v0) == 0:
        return img
    pts = np.concatenate([v0, v1, v2])
    xy, ok = _project(pts, cam, w, h)
    n = len(v0)
    for i in range(n):
        a, b, c = xy[i], xy[i + n], xy[i + 2 * n]
        oa, ob, oc = ok[i], ok[i + n], ok[i + 2 * n]
        if oa and ob:
            draw_line(img, a, b, color)
        if ob and oc:
            draw_line(img, b, c, color)
        if oc and oa:
            draw_line(img, c, a, color)
    return img


def overlay_bvh(img: np.ndarray, host_bvh, cam: Camera, min_depth=0,
                max_depth=None) -> np.ndarray:
    """Per-depth AABB wireframes — the analog of the BVH debug view
    (rvpt.cpp:152-236, 982-994), colored by depth."""
    img = np.array(img, np.float32, copy=True)
    h, w = img.shape[:2]
    levels = host_bvh.collect_aabbs_by_depth()
    if max_depth is None:
        max_depth = len(levels) - 1
    for depth in range(min_depth, min(max_depth + 1, len(levels))):
        boxes = levels[depth]
        hue = depth / max(len(levels) - 1, 1)
        color = (1.0 - hue, hue, 0.25)
        for box in boxes:
            mn, mx = box[:3], box[3:]
            corners = np.array(
                [[mn[0], mn[1], mn[2]], [mx[0], mn[1], mn[2]],
                 [mn[0], mx[1], mn[2]], [mx[0], mx[1], mn[2]],
                 [mn[0], mn[1], mx[2]], [mx[0], mn[1], mx[2]],
                 [mn[0], mx[1], mx[2]], [mx[0], mx[1], mx[2]]]
            )
            xy, ok = _project(corners, cam, w, h)
            for a, b in _EDGES_AABB:
                if ok[a] and ok[b]:
                    draw_line(img, xy[a], xy[b], color)
    return img
