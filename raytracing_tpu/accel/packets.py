"""Host-side acceleration-structure build: the flat cluster hierarchy.

A rethink of the reference's build (/root/reference/src/opt.rs): the
reference stable-sorts triangles by vertex index for spatial locality
(`optimize_model`, opt.rs:11-36), then packs groups of 8 into SIMD packets
and groups of 64 under 8-wide AABB cluster nodes (`pack_model`,
opt.rs:38-80). Here triangles are ordered by an exact surface-area-heuristic
split (the reference's index sort is also available for parity), packed
into clusters of `cluster_size` (a power of two: the walk kernel loads one
cluster as a [cluster_size] vector per row), padded with degenerate
triangles, and each cluster gets an AABB. Traversal tests rays against
cluster AABBs and intersects only the triangles of clusters they enter —
block-granular skipping in the Pallas walk (kernels/traverse.py),
mask-granular in the XLA fallback below.

The walk reads precomputed v0|e1|e2 blocks; everything differentiable
re-gathers the Möller–Trumbore form from the live vertex pool at trace time
(`packed_triangles`, `rest_triangles`), so the structure never blocks
gradient flow to vertices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu.geometry.mesh import Mesh
from raytracing_tpu.ops.intersect import INF, TriangleSoA, moller_trumbore, slab_test
from raytracing_tpu.ops.trace import Hit


class ClusterAccel(NamedTuple):
    """Flat single-level cluster structure over the scene's triangles.

    order:       [S] i32 — packed slot -> original triangle id (padding
                 slots repeat id 0 and are killed by slot_valid).
    slot_valid:  [S] bool — False for padding slots.
    cluster_min: [C, 3] f32 — per-cluster AABB (C = S / cluster_size).
    cluster_max: [C, 3] f32
    tri_blocks:  [C, 9, CS] f32 — v0 | e1 | e2 component rows with the
                 cluster's triangles along the last axis (padding slots
                 have e1 = e2 = 0 and never hit): what the walk kernel
                 loads per visit, one contiguous [CS] row at a time.

    Everything is precomputed host-side at build and detached from the
    autodiff graph (traversal decisions are discrete; the differentiable
    path re-gathers from the live vertex pool). After moving vertices,
    rebuild with `build_cluster_accel` — the standard BVH-refit contract.
    """

    order: jnp.ndarray
    slot_valid: jnp.ndarray
    cluster_min: jnp.ndarray
    cluster_max: jnp.ndarray
    tri_blocks: jnp.ndarray
    # Rest set — the reference's scalar tail loops (opt.rs:69-72
    # rest_tri; consumed at main.rs:157-169): objects with fewer triangles
    # than a cluster would mostly pad (the 2-triangle ground plane costs
    # every ray a whole cluster of tests for 2 real triangles) AND their
    # huge AABBs defeat culling. They are instead intersected by a dense
    # XLA pass over all rays (<= rest_max triangles), merged elementwise
    # with the walk's result. None when empty.
    rest_ids: Optional[jnp.ndarray]      # [Rr] original triangle ids

    @property
    def num_clusters(self) -> int:
        return self.cluster_min.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.order.shape[0] // self.cluster_min.shape[0]

    @property
    def order_ext(self) -> jnp.ndarray:
        """slot -> original triangle id INCLUDING rest slots (rest slot j
        is S + j, S = packed slot count)."""
        if self.rest_ids is None:
            return self.order
        return jnp.concatenate([self.order, self.rest_ids])


def _morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton (Z-order) codes of points normalized to the scene AABB."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    q = ((centroids - lo) / np.maximum(hi - lo, 1e-20) * 1023.0).astype(np.uint32)
    q = np.minimum(q, 1023)

    def expand(v):  # spread 10 bits to every 3rd bit
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])


def _median_split_order(cent: np.ndarray, cs: int) -> np.ndarray:
    """Longest-axis median split into contiguous `cs`-sized runs — the
    leaf layer of an object-median BVH, flattened. Versus a Morton sort
    (whose Z-order jumps leave fat cluster AABBs), the split keeps every
    cluster a compact spatial blob: measured on the teapot frame it cuts
    tile-visit triangle tests from 64 to 28 per ray at cs=8 (and at 404k
    triangles Morton's looser boxes cost ~2x in traversal). Split counts
    are kept multiples of cs so clusters never straddle a split plane.

    Implementation is level-synchronous and fully vectorized (one
    lexsort + reduceat per depth level over ALL segments at once) — the
    per-segment recursive version took ~160 s at 1.6M triangles; this
    runs the same split in a few seconds."""
    n = cent.shape[0]
    order = np.arange(n)
    bounds = np.array([0, n], dtype=np.int64)
    while True:
        lens = np.diff(bounds)
        if (lens <= cs).all():
            return order
        starts = bounds[:-1]
        c = cent[order]
        mins = np.minimum.reduceat(c, starts, axis=0)
        maxs = np.maximum.reduceat(c, starts, axis=0)
        axis = np.argmax(maxs - mins, axis=1)  # [S] per-segment split axis
        seg_id = np.searchsorted(bounds, np.arange(n), side="right") - 1
        keyc = c[np.arange(n), axis[seg_id]]
        idx = np.lexsort((keyc, seg_id))  # stable within segment
        order = order[idx]
        half = np.where(lens > cs,
                        np.maximum((lens // 2 // cs) * cs, cs), 0)
        new_b = (starts + half)[half > 0]
        bounds = np.unique(np.concatenate([bounds, new_b]))


def _sah_split_order(cent: np.ndarray, blo: np.ndarray, bhi: np.ndarray,
                     cs: int) -> np.ndarray:
    """Recursive SAH sweep split into contiguous `cs`-sized runs: at each
    node, try all three axes and every cs-aligned split position, pick the
    one minimizing surface-area x triangle-count (the standard binned-BVH
    objective, swept exactly). On the teapot frame this cuts tile-visit
    triangle tests another ~11% below the median split (43 -> 38 per ray
    at cs=16). O(n log^2 n) host-side numpy, ~100 ms for 12.6k triangles."""
    out = []

    def sa(lo, hi):
        e = np.maximum(hi - lo, 0.0)
        return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] \
            + e[..., 2] * e[..., 0]

    def rec(ids: np.ndarray) -> None:
        k = len(ids)
        if k <= cs:
            out.append(ids)
            return
        best = None
        for ax in range(3):
            srt = ids[np.argsort(cent[ids, ax], kind="stable")]
            lo_pre = np.minimum.accumulate(blo[srt], axis=0)
            hi_pre = np.maximum.accumulate(bhi[srt], axis=0)
            lo_suf = np.minimum.accumulate(blo[srt][::-1], axis=0)[::-1]
            hi_suf = np.maximum.accumulate(bhi[srt][::-1], axis=0)[::-1]
            cands = np.arange(cs, k, cs)
            costs = (sa(lo_pre[cands - 1], hi_pre[cands - 1]) * cands
                     + sa(lo_suf[cands], hi_suf[cands]) * (k - cands))
            j = int(np.argmin(costs))
            if best is None or costs[j] < best[0]:
                best = (costs[j], srt, int(cands[j]))
        _, srt, half = best
        rec(srt[:half])
        rec(srt[half:])

    rec(np.arange(cent.shape[0]))
    return np.concatenate(out)


def _sah_sweep_order(cent: np.ndarray, blo: np.ndarray, bhi: np.ndarray,
                     cs: int) -> np.ndarray:
    """Level-synchronous exact-sweep SAH split — the same objective,
    candidate set (every cs-aligned position, all 3 axes, exact swept
    boxes) and therefore the same cluster quality as `_sah_split_order`,
    but organized so the whole tree level is built at once:

      * the 3 axis-sorted triangle lists are computed ONCE up front and
        maintained through splits by a stable cumsum partition (O(n) per
        level instead of an argsort per node per axis — the recursive
        version's dominant cost, ~2 min at 400k triangles);
      * prefix/suffix swept boxes are evaluated at BLOCK granularity
        (cs triangles per block; candidates only exist at block
        boundaries, so this is exact) over a [segments, max_blocks]
        rectangle, chunked to bound the padding memory.

    Runs in a few seconds at 1.6M triangles, which retires the
    100k-triangle auto fallback to the median split."""
    n = cent.shape[0]
    if n <= cs:
        return np.arange(n)
    nb = (n + cs - 1) // cs

    def sa(lo, hi):
        e = np.maximum(hi - lo, 0.0)
        return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] \
            + e[..., 2] * e[..., 0]

    # Per-axis triangle lists, sorted once; stable so ties match the
    # recursive builder's argsort(kind="stable").
    ids3 = [np.argsort(cent[:, a], kind="stable") for a in range(3)]
    bounds = np.array([0, n], dtype=np.int64)
    pos = np.arange(n, dtype=np.int64)
    big = np.float32(1e30)
    blo = blo.astype(np.float32)
    bhi = bhi.astype(np.float32)
    pad = nb * cs - n

    while True:
        lens = np.diff(bounds)
        live = lens > cs  # segments that still need a split
        if not live.any():
            break
        starts = bounds[:-1]

        # Per-axis block-reduced boxes of the CURRENT orderings (cs
        # triangles per block; segment starts are cs-aligned so blocks
        # never straddle segments). Recomputed once per level.
        blo_b3, bhi_b3 = [], []
        for a in range(3):
            lo_t = blo[ids3[a]]
            hi_t = bhi[ids3[a]]
            if pad:
                lo_t = np.concatenate(
                    [lo_t, np.full((pad, 3), big, np.float32)])
                hi_t = np.concatenate(
                    [hi_t, np.full((pad, 3), -big, np.float32)])
            blo_b3.append(lo_t.reshape(nb, cs, 3).min(axis=1))
            bhi_b3.append(hi_t.reshape(nb, cs, 3).max(axis=1))
        s_starts = starts[live]
        s_lens = lens[live]
        s_blocks = (s_lens + cs - 1) // cs
        s_bstart = s_starts // cs  # starts are cs-aligned by construction

        # Best (cost, axis, split) per live segment, evaluated in
        # length-sorted chunks so the [G, Lmax] rectangles stay bounded.
        best_cost = np.full(len(s_lens), np.inf)
        best_axis = np.zeros(len(s_lens), dtype=np.int64)
        best_kb = np.ones(len(s_lens), dtype=np.int64)
        order_by_len = np.argsort(-s_blocks, kind="stable")
        area_budget = 1 << 24
        g0 = 0
        while g0 < len(order_by_len):
            lmax = int(s_blocks[order_by_len[g0]])
            g1 = min(len(order_by_len),
                     g0 + max(1, area_budget // max(lmax, 1)))
            sel = order_by_len[g0:g1]
            g0 = g1
            G = len(sel)
            L = int(s_blocks[sel].max())
            # Block gather indices (clipped; padding handled by sentinels).
            bidx = s_bstart[sel][:, None] + np.arange(L)[None, :]  # [G, L]
            inseg = np.arange(L)[None, :] < s_blocks[sel][:, None]
            bidx = np.minimum(bidx, nb - 1)
            cost = np.full((G, L), np.inf)
            axis_best = np.zeros((G, L), dtype=np.int64)
            kcand = np.arange(1, L + 1, dtype=np.int64)[None, :] * cs
            n_left = np.minimum(kcand, s_lens[sel][:, None])
            n_right = s_lens[sel][:, None] - n_left
            for a in range(3):
                glo = np.where(inseg[..., None], blo_b3[a][bidx], big)
                ghi = np.where(inseg[..., None], bhi_b3[a][bidx], -big)
                lo_pre = np.minimum.accumulate(glo, axis=1)
                hi_pre = np.maximum.accumulate(ghi, axis=1)
                lo_suf = np.minimum.accumulate(glo[:, ::-1], axis=1)[:, ::-1]
                hi_suf = np.maximum.accumulate(ghi[:, ::-1], axis=1)[:, ::-1]
                # Candidate kb blocks on the left: prefix over blocks
                # [0, kb), suffix over [kb, Lb). Valid kb in [1, Lb-1].
                c_a = np.full((G, L), np.inf)
                c_a[:, :-1] = (
                    sa(lo_pre[:, :-1], hi_pre[:, :-1]) * n_left[:, :-1]
                    + sa(lo_suf[:, 1:], hi_suf[:, 1:]) * n_right[:, :-1]
                )
                valid = (np.arange(1, L + 1)[None, :]
                         < s_blocks[sel][:, None])
                c_a = np.where(valid, c_a, np.inf)
                upd = c_a < cost
                cost = np.where(upd, c_a, cost)
                axis_best = np.where(upd, a, axis_best)
            j = np.argmin(cost, axis=1)
            rows = np.arange(G)
            best_cost[sel] = cost[rows, j]
            best_axis[sel] = axis_best[rows, j]
            best_kb[sel] = j + 1

        # Per-segment split (triangles). Non-live segments keep k = len
        # (everything "left", no new bound).
        k_seg = lens.copy()
        w_seg = np.zeros(len(lens), dtype=np.int64)
        k_seg[live] = best_kb * cs
        w_seg[live] = best_axis

        seg_of = np.searchsorted(bounds, pos, side="right") - 1
        off_in_seg = pos - starts[seg_of]
        left_mask = np.zeros(n, dtype=bool)
        for a in range(3):
            take = (w_seg[seg_of] == a) & (off_in_seg < k_seg[seg_of])
            left_mask[ids3[a][take]] = True

        # Stable partition of every axis list by left-membership, within
        # segments, via segmented cumsum ranks.
        c0_starts = starts[seg_of]
        for a in range(3):
            f = left_mask[ids3[a]]
            c = np.cumsum(f)
            cz = np.concatenate([[0], c])
            c_before_seg = cz[c0_starts]
            left_rank = c - c_before_seg - 1  # valid where f
            taken_left = k_seg[seg_of]  # == left count per segment
            right_rank = off_in_seg - (c - c_before_seg)  # rights before
            newpos = np.where(
                f,
                c0_starts + left_rank,
                c0_starts + taken_left + right_rank,
            )
            out = np.empty(n, dtype=np.int64)
            out[newpos] = ids3[a]
            ids3[a] = out

        new_b = (starts + k_seg)[live]
        bounds = np.unique(np.concatenate([bounds, new_b]))

    return ids3[0]


def _index_sort_order(tri_v: np.ndarray) -> np.ndarray:
    """The reference's locality sort (`optimize_model`, opt.rs:11-36):
    stable sort by min vertex index ascending, max vertex index descending."""
    mn = tri_v.min(axis=1).astype(np.int64)
    mx = tri_v.max(axis=1).astype(np.int64)
    return np.lexsort((-mx, mn)).astype(np.int32)


def build_cluster_accel(
    mesh: Mesh, cluster_size: int = 32, method: str = "auto",
    rest_max: int = 64,
) -> ClusterAccel:
    """Host-side (numpy) build. `method`: "auto" (= "sah" at every scale),
    "sah" (exact-sweep surface-area-heuristic split, level-synchronous —
    tightest clusters, ~20 s at 1.6M tris), "sah-recursive" (the per-node
    reference implementation, same objective, ~8 min at 1.6M — kept as
    the parity oracle), "median" (BVH-leaf median split), "morton"
    (Z-order sort), or "index" (reference-parity locality sort). Objects
    are packed independently so a cluster never spans two objects
    (mirroring the per-object build of opt.rs; keeps cluster AABBs tight
    when objects are far apart).

    Objects smaller than a cluster go to the dense REST SET (up to
    rest_max triangles total; see ClusterAccel.rest_ids) instead of a
    mostly-padding cluster — but only when at least one object is big
    enough to cluster (a rest-only accel would leave the walk nothing)."""
    verts = np.asarray(mesh.verts)
    tri_v = np.asarray(mesh.tri_v)
    obj_id = np.asarray(mesh.obj_id)
    if method == "auto":
        method = "sah"

    n_obj = int(obj_id.max()) + 1 if obj_id.size else 0
    counts = [int((obj_id == oi).sum()) for oi in range(n_obj)]
    any_big = any(k >= cluster_size for k in counts)
    rest_parts: list = []
    rest_budget = rest_max

    order_parts = []
    for oi in range(n_obj):
        sel = np.nonzero(obj_id == oi)[0]
        if len(sel) == 0:
            # A zero-triangle object contributes nothing; appending it to
            # the rest set could make rest_parts non-empty with 0 total
            # rows, and a 0-row rest table crashes the rest-merge reduces.
            continue
        if (any_big and len(sel) < cluster_size
                and len(sel) <= rest_budget):
            rest_parts.append(sel)
            rest_budget -= len(sel)
            continue
        tv = tri_v[sel]
        if method == "index":
            sub = _index_sort_order(tv)
        elif method == "sah":
            tvv = verts[tv]
            cent_s = tvv.mean(axis=1)
            blo_s = tvv.min(axis=1)
            bhi_s = tvv.max(axis=1)
            from raytracing_tpu.geometry import native

            sub = (native.sah_sweep_order(cent_s, blo_s, bhi_s, cluster_size)
                   if native.available() else None)
            if sub is None:
                sub = _sah_sweep_order(cent_s, blo_s, bhi_s, cluster_size)
        elif method == "sah-recursive":
            tvv = verts[tv]
            sub = _sah_split_order(tvv.mean(axis=1), tvv.min(axis=1),
                                   tvv.max(axis=1), cluster_size)
        elif method == "median":
            cent = verts[tv].mean(axis=1)
            sub = _median_split_order(cent, cluster_size)
        else:
            cent = verts[tv].mean(axis=1)
            codes = _morton_codes(cent)
            from raytracing_tpu.geometry import native

            nat = native.morton_order(cent) if native.available() else None
            sub = nat if nat is not None else np.argsort(codes, kind="stable")
        part = sel[sub]
        # Pad each object's slot range to a full cluster so clusters don't
        # straddle objects.
        pad = (-len(part)) % cluster_size
        if pad:
            part = np.concatenate([part, np.full(pad, -1, dtype=part.dtype)])
        order_parts.append(part)

    order = np.concatenate(order_parts).astype(np.int64)
    valid = order >= 0
    order = np.where(valid, order, 0)

    # Cluster AABBs over the actual vertices of valid member triangles.
    c = len(order) // cluster_size
    tri_verts = verts[tri_v[order]].astype(np.float32)  # [S, 3 verts, 3]
    big = np.float32(1e30)
    vmin = np.where(valid[:, None, None], tri_verts, big).reshape(c, -1, 3).min(axis=1)
    vmax = np.where(valid[:, None, None], tri_verts, -big).reshape(c, -1, 3).max(axis=1)

    rest_ids = None
    if rest_parts:
        rest_ids = jnp.asarray(np.concatenate(rest_parts).astype(np.int32))
    return ClusterAccel(
        order=jnp.asarray(order.astype(np.int32)),
        slot_valid=jnp.asarray(valid),
        cluster_min=jnp.asarray(vmin.astype(np.float32)),
        cluster_max=jnp.asarray(vmax.astype(np.float32)),
        tri_blocks=jnp.asarray(_tri_blocks_host(tri_verts, valid, c,
                                                cluster_size)),
        rest_ids=rest_ids,
    )


def _tri_blocks_host(tri_verts: np.ndarray, valid: np.ndarray, c: int,
                     cs: int) -> np.ndarray:
    """[S, 3, 3] packed triangle vertices -> [C, 9, CS] v0|e1|e2 rows —
    the layout of the reference's `pack_triangles` precompute
    (simd_accel.rs:59-63), with degenerate (e1 = e2 = 0) padding."""
    m = valid[:, None].astype(np.float32)
    v0 = tri_verts[:, 0]
    e1 = (tri_verts[:, 1] - v0) * m
    e2 = (tri_verts[:, 2] - v0) * m
    comp = np.concatenate([v0, e1, e2], axis=1)  # [S, 9]
    return np.ascontiguousarray(comp.reshape(c, cs, 9).transpose(0, 2, 1))


_ACCEL_FORMAT_VERSION = 3


def _mesh_fingerprint(mesh: Mesh) -> np.ndarray:
    """64-bit content hash of the geometry an accel was built from:
    verts + tri_v bytes (sha1-truncated; ~50 ms at 1.6M tris)."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.ascontiguousarray(np.asarray(mesh.verts, np.float32)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(mesh.tri_v, np.int32)).tobytes())
    return np.frombuffer(h.digest()[:8], dtype=np.int64).copy()


def save_accel(path: str, accel: ClusterAccel,
               mesh: Optional[Mesh] = None) -> None:
    """Serialize a built accel to one .npz (atomic rename). Production
    serving builds once and ships the structure with the scene — the
    load path is a plain numpy read, no SAH/packing cost. Optional
    fields (None) are simply absent from the archive. Pass `mesh` to
    record a geometry fingerprint so load_accel can reject a cache that
    belongs to a different scene."""
    import os

    arrays = {"_version": np.int64(_ACCEL_FORMAT_VERSION)}
    if mesh is not None:
        arrays["_mesh_fp"] = _mesh_fingerprint(mesh)
    for name, value in accel._asdict().items():
        if value is not None:
            arrays[name] = np.asarray(value)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_accel(path: str, mesh: Optional[Mesh] = None,
               cluster_size: Optional[int] = None) -> ClusterAccel:
    """Inverse of save_accel; arrays land on the default device.
    With `mesh`, the stored geometry fingerprint must match (a stale
    cache for a different scene raises instead of silently rendering the
    wrong geometry); with `cluster_size`, the stored structure's cluster
    size must match."""
    with np.load(path) as z:
        if "_version" not in z.files:
            raise ValueError(
                f"accel file {path}: not a save_accel archive "
                f"(no _version field)")
        version = int(z["_version"])
        if version != _ACCEL_FORMAT_VERSION:
            raise ValueError(
                f"accel file {path}: format v{version}, "
                f"expected v{_ACCEL_FORMAT_VERSION}")
        if mesh is not None:
            if "_mesh_fp" not in z.files:
                raise ValueError(
                    f"accel file {path}: no mesh fingerprint recorded; "
                    f"cannot validate against the current scene")
            if int(z["_mesh_fp"][0]) != int(_mesh_fingerprint(mesh)[0]):
                raise ValueError(
                    f"accel file {path}: built from different geometry "
                    f"than the current scene (mesh fingerprint mismatch)")
        fields = {name: (jnp.asarray(z[name]) if name in z.files else None)
                  for name in ClusterAccel._fields}
    accel = ClusterAccel(**fields)
    if cluster_size is not None and accel.cluster_size != cluster_size:
        raise ValueError(
            f"accel file {path}: cluster_size {accel.cluster_size}, "
            f"expected {cluster_size}")
    return accel


def packed_triangles(mesh: Mesh, accel: ClusterAccel) -> TriangleSoA:
    """Gather the Möller–Trumbore-ready triangle SoA in packed (cluster)
    order from the live vertex pool — differentiable w.r.t. mesh.verts.
    Padding slots get e1 = e2 = 0 (det 0 -> always miss), the counterpart
    of the reference's hard 8-exactly packing contract
    (simd_accel.rs:20-22)."""
    tv = mesh.tri_v[accel.order]
    va = mesh.verts[tv[:, 0]]
    vb = mesh.verts[tv[:, 1]]
    vc = mesh.verts[tv[:, 2]]
    m = accel.slot_valid[:, None].astype(mesh.verts.dtype)
    return TriangleSoA(v0=va, e1=(vb - va) * m, e2=(vc - va) * m)


def _cluster_scan(tri: TriangleSoA, accel: ClusterAccel, o, d, eps, nearest: bool,
                  t_max=INF):
    """Shared XLA cluster walk: scan clusters, slab-cull, intersect members.

    Pure-XLA semantics note: culled work is masked, not skipped; the
    Pallas walk (kernels/traverse.py) performs real block-level skipping.
    """
    cs = accel.cluster_size
    c = accel.num_clusters
    v0 = tri.v0.reshape(c, cs, 3)
    e1 = tri.e1.reshape(c, cs, 3)
    e2 = tri.e2.reshape(c, cs, 3)
    slots = jnp.arange(c * cs, dtype=jnp.int32).reshape(c, cs)
    # Clamp near-zero components before the reciprocal: IEEE inf in the slab
    # test turns into NaN via 0 * inf when a ray origin sits exactly on a
    # cluster boundary (the reference's `recip` precompute has the same
    # latent issue, objects.rs:64-74); the clamp treats axis-parallel rays
    # as infinitesimally diverging, which only loosens culling.
    d_safe = jnp.where(jnp.abs(d) < 1e-20, 1e-20, d)
    inv_d = 1.0 / d_safe
    r = o.shape[0]
    tm = jnp.broadcast_to(jnp.asarray(t_max, dtype=o.dtype), (r,))

    def body(carry, blk):
        best_t, best_i, occ = carry
        bv0, be1, be2, bslot, bmin, bmax = blk
        limit = best_t if nearest else tm
        in_box = slab_test(o, inv_d, bmin, bmax, limit)
        t, valid = moller_trumbore(o[:, None, :], d[:, None, :],
                                   TriangleSoA(bv0, be1, be2),
                                   limit[:, None], eps)
        t = jnp.where(in_box[:, None], t, INF)
        if nearest:
            j = jnp.argmin(t, axis=1)
            tj = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
            better = tj < best_t
            best_t = jnp.where(better, tj, best_t)
            best_i = jnp.where(better, bslot[j], best_i)
        else:
            occ = occ | (in_box & jnp.any(valid, axis=1))
        return (best_t, best_i, occ), None

    init = (jnp.full(r, INF, dtype=o.dtype),
            jnp.zeros(r, dtype=jnp.int32),
            jnp.zeros(r, dtype=bool))
    (t, i, occ), _ = jax.lax.scan(
        body, init,
        (v0, e1, e2, slots, accel.cluster_min, accel.cluster_max))
    return t, i, occ


def rest_triangles(mesh: Mesh, accel: ClusterAccel) -> TriangleSoA:
    """Rest-set triangle SoA from the LIVE vertex pool (differentiable) —
    the dense-path sibling of `packed_triangles`."""
    tv = mesh.tri_v[accel.rest_ids]
    va = mesh.verts[tv[:, 0]]
    vb = mesh.verts[tv[:, 1]]
    vc = mesh.verts[tv[:, 2]]
    return TriangleSoA(v0=va, e1=vb - va, e2=vc - va)


def nearest_hit_cluster(
    mesh: Mesh, accel: ClusterAccel, o, d, eps: float = 1e-8
) -> Hit:
    """Nearest hit through the cluster structure (XLA backend). Returns
    original triangle ids (accel.order applied). The rest set (small
    objects, see ClusterAccel.rest_ids) merges in from a dense pass
    over the live vertex pool."""
    from raytracing_tpu.ops.trace import nearest_hit_brute

    tri = packed_triangles(mesh, accel)
    t, slot, _ = _cluster_scan(tri, accel, o, d, eps, nearest=True)
    tri_id = accel.order[slot]
    if accel.rest_ids is not None:
        rt = rest_triangles(mesh, accel)
        hb = nearest_hit_brute(rt, o, d, eps,
                               block=max(8, accel.rest_ids.shape[0]))
        better = hb.t < t
        t = jnp.minimum(t, hb.t)
        tri_id = jnp.where(better, accel.rest_ids[hb.tri], tri_id)
    return Hit(t=t, tri=tri_id, hit=jnp.isfinite(t))


def any_hit_cluster(
    mesh: Mesh, accel: ClusterAccel, o, d, t_max=INF, eps: float = 1e-8
) -> jnp.ndarray:
    from raytracing_tpu.ops.trace import any_hit_brute

    tri = packed_triangles(mesh, accel)
    _, _, occ = _cluster_scan(tri, accel, o, d, eps, nearest=False, t_max=t_max)
    if accel.rest_ids is not None:
        rt = rest_triangles(mesh, accel)
        occ = occ | any_hit_brute(rt, o, d, t_max, eps,
                                  block=max(8, accel.rest_ids.shape[0]))
    return occ
