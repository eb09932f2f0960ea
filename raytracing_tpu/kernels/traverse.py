"""Cluster-culled nearest-hit and any-hit walk: one Pallas kernel for the GPU.

The reference walks 8-wide SIMD packets under AABB clusters with scalar
early-outs (main.rs:93-234). Here the same early-out traversal runs in
three phases:

  phase 1 (XLA, `_tile_extents`) — each walk block of RAY_BLOCK consecutive
      rays is summarized by the bounding intervals of its ALIVE rays'
      origins and directions (dead lanes may carry garbage and are left
      out).
  phase 2 (XLA, `visit_lists`) — a closed-form interval slab test marks
      every cluster the block's frustum could enter, and one top_k over
      the negated entry lower bounds compacts the marks into a
      front-to-back visit list (cluster ids + true count) per block.
  phase 3 (`_walk_kernel`, Pallas through Triton) — one program per block
      loops over its visit list with a data-dependent trip count. Each
      visit first slab-tests the cluster's AABB against every live ray
      (bounded by the ray's best t so far, or its t_max for occlusion) and
      skips the cluster when no ray enters it; otherwise it loads the
      cluster's triangles (cluster_size x 9 f32: v0|e1|e2) and computes a
      [rays, cluster_size] Möller–Trumbore tile in registers. Nearest
      queries carry the best (t, slot) per ray; occlusion queries stop as
      soon as every live ray of the block is occluded.

A block whose true count exceeds the list width scans every cluster in
index order instead (correct, and such incoherent blocks gain little from
ordering anyway). The dense rest set (small objects, see ClusterAccel)
merges in afterwards from one XLA pass.

The intersection is computed in the operation order of
ops/intersect.moller_trumbore, in f32 on the CUDA cores. The kernel
emits packed slot ids; callers map them to original triangle ids with one
gather over accel.order.

Differentiability: traversal decisions are discrete and detached. The
kernel's t is wrapped in `_lazy_t`, a custom VJP whose forward value is the
kernel's t and whose backward re-derives t from the live vertex pool
through ops/intersect.moller_trumbore (SURVEY.md §7).

The kernel compiles for a CUDA GPU only. Everywhere else the Pallas
interpreter runs it, and only when the caller asks with interpret=True.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytracing_tpu.accel.packets import (
    ClusterAccel,
    rest_triangles,
)
from raytracing_tpu.geometry.mesh import Mesh
from raytracing_tpu.ops.intersect import INF, TriangleSoA, moller_trumbore
from raytracing_tpu.ops.trace import Hit, any_hit_brute, nearest_hit_brute

# Rays per walk program and per culling block (a power of two, as Triton
# requires of the tensors the kernel loads).
RAY_BLOCK = 128
# Visit lists are cut to this width by the top_k compaction; a block whose
# true count is larger scans every cluster (see module docstring).
MAX_VISITS = 256
NUM_WARPS = 4
_TINY = 1e-20
_BIG_ID = 2 ** 30
# Relative and absolute inflation of the per-visit slab interval: the
# intersector's accepted t is rounded along another path than the slab
# bounds, so the box test is loosened by a few ulp and never rejects a
# cluster that holds an accepted hit. Loosening only costs work.
_SLAB_REL = 4e-6
_SLAB_ABS = 1e-7


def _require_gpu(interpret: bool) -> None:
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the pallas backend's walk kernel compiles for a CUDA GPU only "
            f"(JAX's default backend is {jax.default_backend()!r}); use "
            "backend='cluster' or 'bruteforce' here, or pass interpret=True "
            "to run the kernel in the Pallas interpreter")


# ---------------------------------------------------------------------------
# Ray pack
# ---------------------------------------------------------------------------


def rays_to_soa(o: jnp.ndarray, d: jnp.ndarray, alive=None,
                t_max=None) -> jnp.ndarray:
    """[N, 3] origins/directions -> the SoA ray pack [8, N] with rows
    (ox oy oz ALIVE dx dy dz T_MAX). Rows load as contiguous [RAY_BLOCK]
    vectors in the kernel.

    alive: optional [N] bool; dead lanes are left out of culling and may
    carry garbage rays (their results are meaningless). t_max: optional
    scalar or [N] bound of occlusion queries (hits must have t < t_max)."""
    n = o.shape[0]
    row3 = (jnp.ones((1, n), o.dtype) if alive is None
            else alive.astype(o.dtype)[None, :])
    if t_max is None:
        t_max = INF
    row7 = jnp.broadcast_to(jnp.asarray(t_max, o.dtype), (n,))[None, :]
    return jnp.concatenate([o.T, row3, d.T, row7], axis=0)


def _pad_rays(rays8: jnp.ndarray, block: int) -> jnp.ndarray:
    pad = (-rays8.shape[1]) % block
    if pad:
        # Padding rays: finite and dead, so padding blocks visit nothing.
        col = jnp.array([0, 0, 0, 0, 0, 0, 1, 0], rays8.dtype)[:, None]
        rays8 = jnp.concatenate(
            [rays8, jnp.broadcast_to(col, (8, pad))], axis=1)
    return rays8


# ---------------------------------------------------------------------------
# Phase 1 + 2: block-frustum visit lists (XLA)
# ---------------------------------------------------------------------------


def _tile_extents(rays8: jnp.ndarray, block: int):
    """Masked per-block min/max of every pack row over ALIVE lanes:
    (lo [nt, 8], hi [nt, 8], any_alive [nt])."""
    nt = rays8.shape[1] // block
    r = rays8.reshape(8, nt, block)
    alive = r[3] != 0.0
    big = jnp.float32(3e38)
    lo = jnp.where(alive[None], r, big).min(axis=2).T
    hi = jnp.where(alive[None], r, -big).max(axis=2).T
    return lo, hi, jnp.any(alive, axis=1)


def visit_lists(rays8: jnp.ndarray, cluster_min: jnp.ndarray,
                cluster_max: jnp.ndarray, block: int = RAY_BLOCK,
                max_visits: Optional[int] = None):
    """Front-to-back visit lists of every walk block (phases 1-2).

    Returns (ids [nt, W] i32, cnt [nt] i32): the clusters whose AABB the
    block's interval frustum may enter, ordered by entry lower bound, cut
    to W = min(C, max_visits or MAX_VISITS); cnt is the TRUE count (the
    kernel scans all clusters where cnt > W). Blocks with no alive ray get
    cnt = 0."""
    lo, hi, any_alive = _tile_extents(rays8, block)
    o_lo, o_hi = lo[:, 0:3], hi[:, 0:3]
    d_lo, d_hi = lo[:, 4:7], hi[:, 4:7]
    t_near_lb = t_far_ub = None
    for k in range(3):
        spans0 = (d_lo[:, k] <= 0.0) & (d_hi[:, k] >= 0.0)  # [nt]
        dl = jnp.where(jnp.abs(d_lo[:, k]) < _TINY, _TINY, d_lo[:, k])
        dh = jnp.where(jnp.abs(d_hi[:, k]) < _TINY, _TINY, d_hi[:, k])
        i_lo = (1.0 / dh)[:, None]  # [nt, 1]
        i_hi = (1.0 / dl)[:, None]
        e_lo = cluster_min[None, :, k] - o_hi[:, k:k + 1]  # [nt, C]
        e_hi = cluster_max[None, :, k] - o_lo[:, k:k + 1]
        p1, p2 = e_lo * i_lo, e_lo * i_hi
        p3, p4 = e_hi * i_lo, e_hi * i_hi
        t_min_ax = jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4))
        t_max_ax = jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4))
        unb = spans0[:, None]
        t_min_ax = jnp.where(unb, -INF, t_min_ax)
        t_max_ax = jnp.where(unb, INF, t_max_ax)
        t_near_lb = t_min_ax if k == 0 else jnp.maximum(t_near_lb, t_min_ax)
        t_far_ub = t_max_ax if k == 0 else jnp.minimum(t_far_ub, t_max_ax)
    # A cluster entered only beyond every live ray's t_max holds no
    # accepted hit (row 7 of the pack).
    t_far_ub = jnp.minimum(t_far_ub, hi[:, 7:8])
    flags = (t_near_lb <= t_far_ub) & (t_far_ub >= 0.0) & any_alive[:, None]
    keys = jnp.where(flags, t_near_lb, INF)
    width = min(cluster_min.shape[0], max_visits or MAX_VISITS)
    _, ids = jax.lax.top_k(-keys, width)
    cnt = jnp.sum(flags, axis=1, dtype=jnp.int32)
    return ids.astype(jnp.int32), cnt


# ---------------------------------------------------------------------------
# Phase 3: the walk (Pallas, Triton route)
# ---------------------------------------------------------------------------


def _walk_kernel(cnt_ref, ids_ref, bounds_ref, tri_ref, rays_ref, *out_refs,
                 cluster_size, n_clusters, width, eps, nearest):
    """One program = one block of rays, walking its visit list.

    cnt_ref [1], ids_ref [1, W]: the block's true visit count and list;
    bounds_ref [C, 8]: cluster AABB rows (min xyz, max xyz, 0, 0);
    tri_ref [C, 9, CS]: v0 | e1 | e2 rows, triangles along the last axis;
    rays_ref [8, RB]: the block's ray pack (see rays_to_soa).
    Outputs [RB]: nearest -> best t and packed slot; occlusion ->
    occluded 0/1."""
    cs = cluster_size
    ox, oy, oz = rays_ref[0, :], rays_ref[1, :], rays_ref[2, :]
    alive = rays_ref[3, :] != 0.0
    dx, dy, dz = rays_ref[4, :], rays_ref[5, :], rays_ref[6, :]
    t_max = rays_ref[7, :]
    # Reciprocal direction for the slab test; near-zero components are
    # clamped as in accel.packets._cluster_scan (0 * inf would be NaN).
    inv = tuple(1.0 / jnp.where(jnp.abs(c) < _TINY, _TINY, c)
                for c in (dx, dy, dz))
    org = (ox, oy, oz)
    # Column forms [RB, 1] for the [RB, CS] intersection tile.
    oxc, oyc, ozc = ox[:, None], oy[:, None], oz[:, None]
    dxc, dyc, dzc = dx[:, None], dy[:, None], dz[:, None]
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, cs), 1)

    def any_(x):  # Triton lowers no boolean reductions
        return jnp.max(x.astype(jnp.int32)) > 0

    cnt = cnt_ref[0]
    overflow = cnt > width
    trips = jnp.where(overflow, n_clusters, cnt)

    def cluster_at(j):
        return jnp.where(overflow, j, ids_ref[0, jnp.minimum(j, width - 1)])

    def enters(cid, limit):
        """[RB] bool: the ray's slab interval meets the cluster AABB below
        `limit` (inflated a few ulp, see _SLAB_REL)."""
        tn = tf = None
        for k in range(3):
            t1 = (bounds_ref[cid, k] - org[k]) * inv[k]
            t2 = (bounds_ref[cid, k + 3] - org[k]) * inv[k]
            lo_, hi_ = jnp.minimum(t1, t2), jnp.maximum(t1, t2)
            tn = lo_ if k == 0 else jnp.maximum(tn, lo_)
            tf = hi_ if k == 0 else jnp.minimum(tf, hi_)
        tn = tn - (jnp.abs(tn) * _SLAB_REL + _SLAB_ABS)
        tf = tf + (jnp.abs(tf) * _SLAB_REL + _SLAB_ABS)
        return alive & (tn <= jnp.minimum(tf, limit)) & (tf >= 0.0)

    def tri_t(cid, limit):
        """[RB, CS] Möller–Trumbore t (+inf where rejected), in the
        operation order of ops/intersect.moller_trumbore."""
        def row(k):
            return tri_ref[cid, k, :][None, :]

        v0x, v0y, v0z = row(0), row(1), row(2)
        e1x, e1y, e1z = row(3), row(4), row(5)
        e2x, e2y, e2z = row(6), row(7), row(8)
        px = dyc * e2z - dzc * e2y
        py = dzc * e2x - dxc * e2z
        pz = dxc * e2y - dyc * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = jnp.abs(det) >= eps
        inv_det = 1.0 / jnp.where(ok, det, 1.0)
        sx, sy, sz = oxc - v0x, oyc - v0y, ozc - v0z
        u = (sx * px + sy * py + sz * pz) * inv_det
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = (dxc * qx + dyc * qy + dzc * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps))
        if limit is not None:
            valid = valid & (t < limit)
        return jnp.where(valid, t, INF)

    if nearest:
        def body(j, carry):
            cid = cluster_at(j)

            def visit(c):
                best_t, best_s = c
                t = tri_t(cid, None)
                tmin = jnp.min(t, axis=1)
                slot = cid * cs + lane
                smin = jnp.min(jnp.where(t == tmin[:, None], slot, _BIG_ID),
                               axis=1)
                # Global tie rule: least t, then least slot (a tie of two
                # misses is no tie).
                upd = (tmin < best_t) | ((tmin == best_t) & (tmin < INF)
                                         & (smin < best_s))
                return (jnp.where(upd, tmin, best_t),
                        jnp.where(upd, smin, best_s))

            return jax.lax.cond(any_(enters(cid, carry[0])), visit,
                                lambda c: c, carry)

        init = (jnp.full(ox.shape, INF, jnp.float32),
                jnp.full(ox.shape, _BIG_ID, jnp.int32))
        best_t, best_s = jax.lax.fori_loop(0, trips, body, init)
        t_ref, s_ref = out_refs
        t_ref[...] = best_t
        s_ref[...] = best_s
    else:
        def cond(c):
            j, occ = c
            return (j < trips) & any_((occ == 0) & alive)

        def body(c):
            j, occ = c
            cid = cluster_at(j)
            live = enters(cid, t_max) & (occ == 0)

            def visit(occ):
                t = tri_t(cid, t_max[:, None])
                hit = jnp.min(t, axis=1) < INF
                return jnp.where(hit, 1, occ)

            return j + 1, jax.lax.cond(any_(live), visit,
                                       lambda x: x, occ)

        _, occ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.zeros(ox.shape, jnp.int32)))
        out_refs[0][...] = occ


def _walk(accel: ClusterAccel, rays8: jnp.ndarray, eps: float,
          nearest: bool, interpret: bool, block: int = RAY_BLOCK,
          num_warps: int = NUM_WARPS):
    """Phases 1-3 over the ray pack [8, N]: nearest -> (t [N] f32, packed
    slot [N] i32); occlusion -> occluded [N] i32 (0/1)."""
    _require_gpu(interpret)
    cs = accel.cluster_size
    if cs & (cs - 1):
        raise ValueError(f"the walk needs a power-of-two cluster size, "
                         f"not {cs}")
    n = rays8.shape[1]
    rays8 = _pad_rays(jax.lax.stop_gradient(rays8), block)
    n_pad = rays8.shape[1]
    ids, cnt = visit_lists(rays8, accel.cluster_min, accel.cluster_max,
                           block)
    c, width = accel.num_clusters, ids.shape[1]
    bounds = jnp.concatenate(
        [accel.cluster_min, accel.cluster_max,
         jnp.zeros((c, 2), accel.cluster_min.dtype)], axis=1)
    tri = accel.tri_blocks
    kernel = functools.partial(
        _walk_kernel, cluster_size=cs, n_clusters=c, width=width, eps=eps,
        nearest=nearest)
    out_shape = [jax.ShapeDtypeStruct((n_pad,), jnp.int32)]
    if nearest:
        out_shape.insert(0, jax.ShapeDtypeStruct((n_pad,), jnp.float32))
    out = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_pad // block,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (i,)),
            pl.BlockSpec((1, width), lambda i: (i, 0)),
            pl.BlockSpec(bounds.shape, lambda i: (0, 0)),
            pl.BlockSpec(tri.shape, lambda i: (0, 0, 0)),
            pl.BlockSpec((8, block), lambda i: (0, i)),
        ],
        out_specs=[pl.BlockSpec((block,), lambda i: (i,))] * len(out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="nearest_walk" if nearest else "occlusion_walk",
    )(cnt, ids, bounds, tri, rays8)
    if nearest:
        return out[0][:n], out[1][:n]
    return out[0][:n]


# ---------------------------------------------------------------------------
# Gradient rule: forward = kernel t, backward = live-vertex re-derivation
# ---------------------------------------------------------------------------


@jax.custom_vjp
def _lazy_t(verts, o, d, tri_v, tri_id, hit, t_k):
    return t_k


def _lazy_t_fwd(verts, o, d, tri_v, tri_id, hit, t_k):
    return t_k, (verts, o, d, tri_v, tri_id, hit)


def _lazy_t_bwd(res, g):
    verts, o, d, tri_v, tri_id, hit = res
    tvs = tri_v[jnp.where(hit, tri_id, 0)]  # [R, 3] winning-tri verts
    va = verts[tvs[:, 0]]
    vb = verts[tvs[:, 1]]
    vc = verts[tvs[:, 2]]

    def t_math(va_, vb_, vc_, o_, d_):
        t_d, _ = moller_trumbore(
            o_, d_, TriangleSoA(va_, vb_ - va_, vc_ - va_), INF, 1e-8)
        return jnp.where(hit & jnp.isfinite(t_d), t_d, 0.0)

    _, vjp = jax.vjp(t_math, va, vb, vc, o, d)
    dva, dvb, dvc, do, dd = vjp(jnp.where(hit, g, 0.0))
    # Per-corner gradients reach the vertex pool through one sort-based
    # segment reduction over all 3 corners (ops/scatter.py); dead lanes
    # target the drop bucket n_v.
    from raytracing_tpu.ops.scatter import segment_scatter_add

    n_v = verts.shape[0]
    tv_all = jnp.concatenate(
        [jnp.where(hit, tvs[:, k], n_v) for k in range(3)])
    dv_all = jnp.concatenate([dva, dvb, dvc], axis=0)
    dverts = segment_scatter_add(n_v, tv_all, dv_all).astype(verts.dtype)
    return dverts, do, dd, None, None, None, None


_lazy_t.defvjp(_lazy_t_fwd, _lazy_t_bwd)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def nearest_hit_pallas(
    mesh: Mesh,
    accel: ClusterAccel,
    o: jnp.ndarray,
    d: jnp.ndarray,
    eps: float = 1e-8,
    alive: Optional[jnp.ndarray] = None,
    interpret: bool = False,
) -> Hit:
    """Nearest hit through the walk kernel, with the rest set merged.
    Returns original triangle ids; t is the kernel's value forward and
    differentiates through `_lazy_t` backward."""
    sg = jax.lax.stop_gradient
    t_k, slot = _walk(accel, rays_to_soa(sg(o), sg(d), alive), eps,
                      nearest=True, interpret=interpret)
    hit = jnp.isfinite(t_k)
    tri_id = jnp.where(hit, accel.order[jnp.where(hit, slot, 0)], 0)
    if accel.rest_ids is not None:
        rt = rest_triangles(jax.tree_util.tree_map(sg, mesh), accel)
        hb = nearest_hit_brute(rt, sg(o), sg(d), eps,
                               block=max(8, accel.rest_ids.shape[0]))
        better = hb.t < t_k
        t_k = jnp.minimum(t_k, hb.t)
        tri_id = jnp.where(better, accel.rest_ids[hb.tri], tri_id)
        hit = jnp.isfinite(t_k)
    t = _lazy_t(mesh.verts, o, d, sg(mesh.tri_v), tri_id, hit, t_k)
    return Hit(t=t, tri=tri_id, hit=hit)


def any_hit_pallas(
    mesh: Mesh,
    accel: ClusterAccel,
    o: jnp.ndarray,
    d: jnp.ndarray,
    eps: float = 1e-8,
    t_max=INF,
    alive: Optional[jnp.ndarray] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Occlusion through the walk kernel: does any triangle meet (o, d)
    with eps < t < t_max? t_max is a scalar or a per-ray [N] bound."""
    sg = jax.lax.stop_gradient
    o, d = sg(o), sg(d)
    t_max = sg(jnp.asarray(t_max, o.dtype))
    occ = _walk(accel, rays_to_soa(o, d, alive, t_max), eps,
                nearest=False, interpret=interpret) != 0
    if accel.rest_ids is not None:
        rt = rest_triangles(jax.tree_util.tree_map(sg, mesh), accel)
        occ = occ | any_hit_brute(rt, o, d, t_max, eps,
                                  block=max(8, accel.rest_ids.shape[0]))
    return occ
