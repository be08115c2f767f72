"""Bounding-volume hierarchy over the sphere table.

The reference defines a bvh_node (hittable.h:41-140) that is never
instantiated by any scene and contains real bugs: the build sorts
``[&l[0], &l[n-1])`` excluding the last element (hittable.h:66), assigns
`left` twice for n > 2 leaving `right` dangling (hittable.h:82-83), and
`hit()` tests `left` for both children (hittable.h:102-103). This module is
the working replacement (SURVEY.md §7 step 6):

- build on host with numpy: top-down median split on the widest centroid
  axis over motion-expanded sphere AABBs (the union box of
  movement_linear, sphere.h:27-37);
- flatten to a DFS pre-order array with *skip links*: traversal needs no
  stack — on a box hit, advance to node+1; on a miss (or after a leaf),
  jump to skip[node]. Every ray carries one int32 node cursor, which is
  the wavefront/SIMD-friendly formulation;
- traverse under jit with a masked lax.while_loop: rays step in lockstep,
  each through its own cursor, gathering node boxes from a table that is
  tiny next to HBM.

Intended for large scenes: opt-in (SceneBuilder.build(use_bvh=True));
tools/bvh_bench.py times it against the dense geometry.hit_spheres scan.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..models import scene_types as st
from ..utils.pytree import pytree_dataclass
from . import linalg
from .geometry import BIG

LEAF_SIZE = 4  # max spheres per leaf; static unroll bound in traversal


@pytree_dataclass
class SphereBVH:
    """Flattened skip-link BVH. M nodes in DFS pre-order."""
    bbox_min: jnp.ndarray  # (M, 3)
    bbox_max: jnp.ndarray  # (M, 3)
    skip: jnp.ndarray      # (M,) int32: next node on miss / after a leaf
    first: jnp.ndarray     # (M,) int32: first slot in `order` (leaves)
    count: jnp.ndarray     # (M,) int32: spheres in leaf; 0 for internal
    order: jnp.ndarray     # (S,) int32: leaf-order permutation of sphere rows

    def num_nodes(self) -> int:
        return self.skip.shape[0]


def _sphere_bounds(spheres: st.Spheres):
    """Motion-expanded per-sphere AABBs (numpy, host)."""
    c0 = np.asarray(spheres.center0, np.float64)
    c1 = np.asarray(spheres.center1, np.float64)
    r = np.abs(np.asarray(spheres.radius, np.float64))[:, None]
    lo = np.minimum(c0, c1) - r
    hi = np.maximum(c0, c1) + r
    return lo, hi


def build_sphere_bvh(spheres: st.Spheres, leaf_size: int = LEAF_SIZE
                     ) -> SphereBVH:
    """Host-side top-down median-split build over the ACTIVE spheres."""
    active = np.asarray(spheres.active)
    idx_all = np.nonzero(active)[0].astype(np.int32)
    lo, hi = _sphere_bounds(spheres)
    centroids = (lo + hi) * 0.5

    nodes_min, nodes_max, sizes, first, count = [], [], [], [], []
    order: list[int] = []

    def emit(idx) -> int:
        """Append the subtree over sphere rows `idx` in DFS pre-order;
        returns the subtree's node count."""
        me = len(sizes)
        nodes_min.append(lo[idx].min(axis=0))
        nodes_max.append(hi[idx].max(axis=0))
        sizes.append(1)
        if len(idx) <= leaf_size:
            first.append(len(order))
            count.append(len(idx))
            order.extend(int(i) for i in idx)
            return 1
        first.append(-1)
        count.append(0)
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = len(idx) // 2
        part = idx[np.argsort(c[:, axis], kind="stable")]
        n = 1 + emit(part[:mid])
        n += emit(part[mid:])
        sizes[me] = n
        return n

    if len(idx_all) == 0:
        z3 = jnp.zeros((1, 3), jnp.float32)
        return SphereBVH(bbox_min=z3, bbox_max=z3,
                         skip=jnp.asarray([1], jnp.int32),
                         first=jnp.asarray([0], jnp.int32),
                         count=jnp.asarray([0], jnp.int32),
                         order=jnp.zeros((0,), jnp.int32))

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * len(idx_all) + 100))
    try:
        emit(idx_all)
    finally:
        sys.setrecursionlimit(old_limit)
    M = len(sizes)
    # In pre-order, "resume after missing node n's box" = the next node
    # past n's whole subtree: skip[n] = n + subtree_size(n). M means done.
    skip_final = (np.arange(M, dtype=np.int64)
                  + np.asarray(sizes, np.int64)).astype(np.int32)

    return SphereBVH(
        bbox_min=jnp.asarray(np.asarray(nodes_min), jnp.float32),
        bbox_max=jnp.asarray(np.asarray(nodes_max), jnp.float32),
        skip=jnp.asarray(skip_final),
        first=jnp.asarray(first, jnp.int32),
        count=jnp.asarray(count, jnp.int32),
        order=jnp.asarray(order, jnp.int32))


def _leaf_sphere_t(o, d, time, t_min, spheres: st.Spheres, si, moving: bool):
    """Candidate t for one gathered sphere row per ray (N,). BIG on miss."""
    c = spheres.center0[si]
    if moving:
        dt = spheres.time1[si] - spheres.time0[si]
        inv_dt = jnp.where(dt != 0, 1.0 / jnp.where(dt != 0, dt, 1.0), 0.0)
        frac = (time - spheres.time0[si]) * inv_dt
        c = c + frac[:, None] * (spheres.center1[si] - spheres.center0[si])
    oc = o - c
    a = linalg.dot(d, d)
    b = linalg.dot(oc, d)
    cc = linalg.dot(oc, oc) - spheres.radius[si] ** 2
    disc = b * b - a * cc
    sq = linalg.safe_sqrt(disc)
    t_near = (-b - sq) / a
    t_far = (-b + sq) / a
    t_cand = jnp.where(t_near > t_min, t_near, t_far)
    valid = (disc > 0) & (t_cand > t_min)
    return jnp.where(valid, t_cand, BIG)


def hit_spheres_bvh(o, d, time, t_min, spheres: st.Spheres,
                    bvh: SphereBVH, moving: bool):
    """Closest sphere hit via stackless skip-link traversal.

    Returns (best_t (N,), best_idx (N,) int32) like geometry.hit_spheres.
    """
    N = o.shape[0]
    M = bvh.num_nodes()
    inv_d = 1.0 / d  # per-ray, hoisted out of the loop

    def cond(state):
        node, best_t, best_i = state
        return jnp.any(node < M)

    def body(state):
        node, best_t, best_i = state
        safe = jnp.minimum(node, M - 1)
        bmin = bvh.bbox_min[safe]          # (N, 3)
        bmax = bvh.bbox_max[safe]
        t0 = (bmin - o) * inv_d
        t1 = (bmax - o) * inv_d
        tlo = jnp.max(jnp.minimum(t0, t1), axis=-1)
        thi = jnp.min(jnp.maximum(t0, t1), axis=-1)
        box_hit = (jnp.maximum(tlo, t_min) < jnp.minimum(thi, best_t))

        cnt = bvh.count[safe]
        is_leaf = cnt > 0
        test_leaf = box_hit & is_leaf

        for k in range(LEAF_SIZE):
            in_leaf = test_leaf & (k < cnt)
            slot = jnp.clip(bvh.first[safe] + k, 0,
                            max(bvh.order.shape[0] - 1, 0))
            si = bvh.order[slot] if bvh.order.shape[0] else jnp.zeros_like(
                slot)
            t_cand = _leaf_sphere_t(o, d, time, t_min, spheres, si, moving)
            better = in_leaf & (t_cand < best_t)
            best_t = jnp.where(better, t_cand, best_t)
            best_i = jnp.where(better, si, best_i)

        live = node < M
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, node + 1, bvh.skip[safe])
        node = jnp.where(live, nxt, node)
        return node, best_t, best_i

    state = (jnp.zeros((N,), jnp.int32), jnp.full((N,), BIG),
             jnp.full((N,), -1, jnp.int32))
    node, best_t, best_i = jax.lax.while_loop(cond, body, state)
    return best_t, best_i
