"""Midpoint (1:4) triangle subdivision — scales any mesh to the ~1M-triangle
regime (BASELINE config 4: "~1M-triangle mesh (subdivided teapot)").

Each level splits every triangle into 4 at its edge midpoints, deduplicating
midpoint vertices through a shared edge map so the result stays a watertight
indexed mesh (T -> 4T triangles, V -> V + E vertices). Midpoint subdivision
of flat triangles reproduces the SAME surface exactly — renders of the
subdivided mesh must match the original up to floating-point edge cases —
which makes it both a large-scene stress generator and its own correctness
oracle. Host-side numpy; runs once at scene build.

The reference has no counterpart (its scene is fixed at 12,642 triangles);
this exists because an accelerator is idle at that size.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def subdivide_arrays(
    verts: np.ndarray, tri_v: np.ndarray, levels: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """(verts [V,3], tri_v [T,3]) -> subdivided (verts', tri_v'), numpy."""
    verts = np.asarray(verts, dtype=np.float32)
    tri_v = np.asarray(tri_v, dtype=np.int64)
    from raytracing_tpu.geometry import native

    for _ in range(levels):
        # Native one-level twin (csrc rt_subdivide_level): identical
        # output (same unique-key midpoint order), ~10x faster at the
        # 4.8M-edge level. Falls through to numpy per level if absent.
        if native.available():
            out = native.subdivide_level(verts, tri_v)
            if out is not None:
                verts, tri_v = out
                tri_v = tri_v.astype(np.int64)
                continue
        a, b, c = tri_v[:, 0], tri_v[:, 1], tri_v[:, 2]
        # Canonical (lo, hi) edge keys shared across adjacent triangles,
        # encoded as ONE int64 per edge: np.unique on a 1-D integer array
        # is a plain sort, while unique(axis=0) goes through a void-dtype
        # view that measured ~10x slower at the 4.8M edges of the 1.6M-tri
        # level.
        e0 = np.concatenate([a, b, c])
        e1 = np.concatenate([b, c, a])
        lo = np.minimum(e0, e1)
        hi = np.maximum(e0, e1)
        v0 = verts.shape[0]
        keys = lo * np.int64(v0) + hi
        uniq, inv = np.unique(keys, return_inverse=True)
        ulo = uniq // v0
        uhi = uniq - ulo * v0
        mid = (verts[ulo] + verts[uhi]) * 0.5  # [E, 3]
        verts = np.concatenate([verts, mid.astype(np.float32)])
        t = tri_v.shape[0]
        mab = v0 + inv[:t]
        mbc = v0 + inv[t:2 * t]
        mca = v0 + inv[2 * t:]
        tri_v = np.concatenate(
            [
                np.stack([a, mab, mca], 1),
                np.stack([mab, b, mbc], 1),
                np.stack([mca, mbc, c], 1),
                np.stack([mab, mbc, mca], 1),
            ]
        )
    return verts, tri_v.astype(np.int32)
