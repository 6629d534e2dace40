"""BVH: flat node arrays and the host-side binned-SAH builder (mirror of
``rvpt_tpu/scene/bvh.py``).

Same algorithm and data layout as the reference's CPU builder
(src/rvpt/bvh_builder.cpp:11-199, src/rvpt/bvh.h:12-86): 16 SAH bins, leaves
of 2-8 primitives, nodes as (first_child_or_primitive, primitive_count,
bounds); sibling children are allocated contiguously so an interior node
stores only its left child index; triangles are permuted into leaf order so
a leaf references a contiguous range (bvh.h:72-79).

The two reference defects are fixed as in the JAX package (PARITY.md row
9): the partition bins exactly as the cost search does
(bvh_builder.cpp:44-46), and the median fallback splits at
``begin + count/2`` (bvh_builder.cpp:167).

The builder runs on the host at scene build time: the C++ one in
``native/rvpt_native.cpp`` first (``rvpt_tpu_torch.native``), this NumPy
one where that library cannot be built; both produce the same tree.  The
tree then lives as tensors on the scene's device (``Bvh``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.checkpoint import STATIC

BIN_COUNT = 16  # bvh_builder.h:49-50
MIN_PRIMS_PER_LEAF = 2  # bvh_builder.h:45
MAX_PRIMS_PER_LEAF = 8  # bvh_builder.h:46


@dataclasses.dataclass(frozen=True)
class Bvh:
    """Device-side flat BVH (the SSBO layout of bvh.h:12-58 as SoA tensors).
    ``builder`` names the builder that made it ("native" or "numpy"),
    ``depth`` is the deepest node's depth (the root is 0)."""

    first: torch.Tensor  # int32[M]: first child (interior) or first primitive (leaf)
    count: torch.Tensor  # int32[M]: 0 for interior nodes, else leaf primitive count
    bmin: torch.Tensor  # f32[M,3]
    bmax: torch.Tensor  # f32[M,3]
    max_leaf: int = dataclasses.field(default=MAX_PRIMS_PER_LEAF, metadata=STATIC)
    depth: int = dataclasses.field(default=0, metadata=STATIC)
    builder: str = dataclasses.field(default="numpy", metadata=STATIC)

    @property
    def num_nodes(self) -> int:
        return self.first.shape[0]

    def host_view(self) -> "BvhHost":
        """The tree on the host over the leaf-ordered triangles it indexes
        (the identity permutation), for ``validate``."""
        count = self.count.cpu().numpy().astype(np.uint32)
        return BvhHost(
            first=self.first.cpu().numpy().astype(np.uint32),
            count=count,
            bmin=self.bmin.cpu().numpy(),
            bmax=self.bmax.cpu().numpy(),
            prim_indices=np.arange(int(count.sum()), dtype=np.uint32),
        )


def node_depths(first: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Depth of every node (the root is 0), level by level: the children
    of interior node i are first[i] and first[i] + 1."""
    first = np.asarray(first, np.int64)
    count = np.asarray(count, np.int64)
    depth = np.zeros(len(first), np.int64)
    level, d = np.zeros(1, np.int64), 0
    while len(level):
        depth[level] = d
        inner = level[count[level] == 0]
        level = np.concatenate([first[inner], first[inner] + 1])
        d += 1
    return depth


@dataclasses.dataclass
class BvhHost:
    """Host-side build result (before device upload)."""

    first: np.ndarray
    count: np.ndarray
    bmin: np.ndarray
    bmax: np.ndarray
    prim_indices: np.ndarray  # permutation: leaf-order -> original ids

    def to_device(self, device, builder: str = "numpy") -> Bvh:
        return Bvh(
            first=torch.as_tensor(self.first.astype(np.int32), device=device),
            count=torch.as_tensor(self.count.astype(np.int32), device=device),
            bmin=torch.as_tensor(self.bmin.astype(np.float32), device=device),
            bmax=torch.as_tensor(self.bmax.astype(np.float32), device=device),
            max_leaf=(int(self.count.max()) if len(self.count)
                      else MAX_PRIMS_PER_LEAF),
            depth=self.max_depth(),
            builder=builder,
        )

    def max_depth(self) -> int:
        return int(node_depths(self.first, self.count).max())

    def collect_aabbs_by_depth(self) -> list[np.ndarray]:
        """Per-depth list of [K,6] (min,max) boxes, nodes in index order —
        the BVH wireframe debug view's data source (reference:
        bvh.cpp:7-26)."""
        depth = node_depths(self.first, self.count)
        boxes = np.concatenate([self.bmin, self.bmax], axis=1)
        return [boxes[depth == d] for d in range(int(depth.max()) + 1)]


def _half_area(bmin, bmax):
    """AABB half surface area (reference: geometry.h:38-41); degenerate boxes
    clamp their diagonal at zero."""
    d = np.maximum(bmax - bmin, 0.0)
    return d[..., 0] * (d[..., 1] + d[..., 2]) + d[..., 1] * d[..., 2]


def build_bvh(centers: np.ndarray, bmin: np.ndarray, bmax: np.ndarray) -> BvhHost:
    """Binned-SAH build over primitive AABBs (vectorized inner sweeps, explicit
    work stack instead of recursion)."""
    n = len(centers)
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    centers = np.asarray(centers, np.float64)
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)

    prim_idx = np.arange(n, dtype=np.uint32)
    firsts = [0]
    counts = [n]
    node_bmin = [np.zeros(3)]
    node_bmax = [np.zeros(3)]

    # Work stack of node ids whose [first, first+count) span needs processing.
    stack = [0]
    while stack:
        node = stack.pop()
        begin = firsts[node]
        count = counts[node]
        ids = prim_idx[begin : begin + count]
        nb_min = bmin[ids].min(axis=0)
        nb_max = bmax[ids].max(axis=0)
        node_bmin[node] = nb_min
        node_bmax[node] = nb_max
        if count < MIN_PRIMS_PER_LEAF:
            continue

        # --- find_best_split (bvh_builder.cpp:56-127), vectorized per axis.
        diag = np.maximum(nb_max - nb_min, 1e-30)
        min_cost = np.inf
        min_axis, min_bin = -1, 0
        cen = centers[ids]
        for axis in range(3):
            scale = BIN_COUNT / diag[axis]
            b = ((cen[:, axis] - nb_min[axis]) * scale).astype(np.int64)
            b = np.clip(b, 0, BIN_COUNT - 1)
            bin_counts = np.bincount(b, minlength=BIN_COUNT)
            bin_bmin = np.full((BIN_COUNT, 3), np.inf)
            bin_bmax = np.full((BIN_COUNT, 3), -np.inf)
            for k in range(3):
                np.minimum.at(bin_bmin[:, k], b, bmin[ids][:, k])
                np.maximum.at(bin_bmax[:, k], b, bmax[ids][:, k])
            # prefix (left) sweep
            left_min = np.minimum.accumulate(bin_bmin, axis=0)
            left_max = np.maximum.accumulate(bin_bmax, axis=0)
            left_cnt = np.cumsum(bin_counts)
            left_cost = _half_area(left_min, left_max) * left_cnt
            # suffix (right) sweep
            right_min = np.minimum.accumulate(bin_bmin[::-1], axis=0)[::-1]
            right_max = np.maximum.accumulate(bin_bmax[::-1], axis=0)[::-1]
            right_cnt = np.cumsum(bin_counts[::-1])[::-1]
            # split at bin i means right = bins[i:], left = bins[:i]
            cost = (
                _half_area(right_min[1:], right_max[1:]) * right_cnt[1:]
                + left_cost[:-1]
            )
            cost = np.where(np.isfinite(cost), cost, np.inf)
            i = int(np.argmin(cost))
            if cost[i] < min_cost:
                min_cost = cost[i]
                min_axis = axis
                min_bin = i + 1

        no_split_cost = _half_area(nb_min, nb_max) * count
        if min_cost >= no_split_cost or min_axis < 0:
            if count <= MAX_PRIMS_PER_LEAF:
                continue
            # median fallback (bvh_builder.cpp:162-167, precedence bug fixed)
            axis = max(min_axis, 0)
            order = np.argsort(centers[ids][:, axis], kind="stable")
            prim_idx[begin : begin + count] = ids[order]
            mid = begin + (count >> 1)
        else:
            scale = BIN_COUNT / diag[min_axis]
            b = ((cen[:, min_axis] - nb_min[min_axis]) * scale).astype(np.int64)
            b = np.clip(b, 0, BIN_COUNT - 1)
            go_left = b < min_bin
            # stable partition preserves relative order like std::partition
            prim_idx[begin : begin + count] = np.concatenate(
                [ids[go_left], ids[~go_left]]
            )
            mid = begin + int(go_left.sum())
            if mid == begin or mid == begin + count:
                # numerically degenerate split: fall back to median
                order = np.argsort(centers[ids][:, min_axis], kind="stable")
                prim_idx[begin : begin + count] = ids[order]
                mid = begin + (count >> 1)

        left = len(firsts)
        firsts += [begin, mid]
        counts += [mid - begin, begin + count - mid]
        node_bmin += [np.zeros(3), np.zeros(3)]
        node_bmax += [np.zeros(3), np.zeros(3)]
        firsts[node] = left
        counts[node] = 0
        stack.append(left)
        stack.append(left + 1)

    return BvhHost(
        first=np.asarray(firsts, np.uint32),
        count=np.asarray(counts, np.uint32),
        bmin=np.asarray(node_bmin, np.float32),
        bmax=np.asarray(node_bmax, np.float32),
        prim_indices=prim_idx,
    )


def triangle_bounds(v0, v1, v2):
    """Per-triangle center + AABB, the builder's input (bvh_builder.h:17-28)."""
    bmin = np.minimum(np.minimum(v0, v1), v2)
    bmax = np.maximum(np.maximum(v0, v1), v2)
    centers = (bmin + bmax) * 0.5  # AABB center, like geometry AABB::center()
    return centers, bmin, bmax


def build_host(v0, v1, v2) -> tuple[BvhHost, str]:
    """(the tree over the triangles (v0, v1, v2) as f32[T,3] arrays, the
    builder that made it): the native builder when its library builds,
    else the NumPy one."""
    from ..native import bvh_native

    centers, bmin, bmax = triangle_bounds(v0, v1, v2)
    host = bvh_native.build(centers, bmin, bmax)
    if host is not None:
        return host, "native"
    return build_bvh(centers, bmin, bmax), "numpy"


def attach_bvh(scene):
    """Build a BVH over the scene's triangles, permute them into leaf order
    (bvh.h:72-79 / rvpt.cpp:85-86), and return the new Scene, the tree on
    the scene's device.  A scene without triangles is returned as is."""
    if scene.num_triangles == 0:
        return scene
    v0, v1, v2 = (x.detach().cpu().numpy() for x in
                  (scene.tri_v0, scene.tri_v1, scene.tri_v2))
    host, builder = build_host(v0, v1, v2)
    perm = torch.as_tensor(host.prim_indices.astype(np.int64),
                           device=scene.device)
    return dataclasses.replace(
        scene,
        tri_v0=scene.tri_v0[perm],
        tri_v1=scene.tri_v1[perm],
        tri_v2=scene.tri_v2[perm],
        tri_mat=scene.tri_mat[perm],
        bvh=host.to_device(scene.device, builder),
    )


def validate(host: BvhHost, bmin: np.ndarray, bmax: np.ndarray) -> None:
    """Structural invariants: every primitive in exactly one leaf; node
    boxes contain their children; sibling layout contiguous.  Raises
    ``ValueError`` on the first that fails."""
    def need(cond, msg):
        if not cond:
            raise ValueError(msg)

    n_prims = len(host.prim_indices)
    need(np.array_equal(np.sort(host.prim_indices), np.arange(n_prims)),
         "prim_indices is not a permutation")
    covered = np.zeros(n_prims, bool)
    for i in range(len(host.first)):
        if host.count[i] > 0:
            s = slice(int(host.first[i]), int(host.first[i] + host.count[i]))
            need(not covered[s].any(), "overlapping leaves")
            covered[s] = True
            ids = host.prim_indices[s]
            need((host.bmin[i] <= bmin[ids].min(axis=0) + 1e-5).all()
                 and (host.bmax[i] >= bmax[ids].max(axis=0) - 1e-5).all(),
                 f"leaf {i} does not contain its primitives")
        else:
            c = int(host.first[i])
            need(c + 1 < len(host.first), f"node {i} points past the nodes")
            for ch in (c, c + 1):
                need((host.bmin[i] <= host.bmin[ch] + 1e-5).all()
                     and (host.bmax[i] >= host.bmax[ch] - 1e-5).all(),
                     f"node {i} does not contain child {ch}")
    need(covered.all(), "primitive not covered by any leaf")
