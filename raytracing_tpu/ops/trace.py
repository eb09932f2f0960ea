"""Scene-level nearest-hit / any-hit queries, brute-force backend.

This is the framework's oracle: every accelerated backend (cluster XLA,
the Pallas walk) must produce results allclose to these functions. It
replaces the reference's 3-stage walk over PackedBoxes/PackedTriangles/rest
loops (/root/reference/src/main.rs:93-171 nearest, :176-234 any-hit) with a
block-scanned full intersection — the "early-out" structure of the
reference is replaced by masked vector work; culling arrives with the accel
backends.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from raytracing_tpu.ops.intersect import INF, TriangleSoA, moller_trumbore


class Hit(NamedTuple):
    """Nearest-hit result for a ray batch: t [R] (+inf on miss), tri [R]
    (original triangle id, 0 on miss), hit [R] bool."""

    t: jnp.ndarray
    tri: jnp.ndarray
    hit: jnp.ndarray


def _pad_tris(tri: TriangleSoA, block: int) -> Tuple[TriangleSoA, jnp.ndarray, int]:
    t = tri.v0.shape[0]
    n_blocks = max(1, -(-t // block))
    pad = n_blocks * block - t
    if pad:
        # Degenerate padding: e1 = e2 = 0 -> det = 0 -> guaranteed miss.
        zp = jnp.zeros((pad, 3), dtype=tri.v0.dtype)
        tri = TriangleSoA(
            v0=jnp.concatenate([tri.v0, zp]),
            e1=jnp.concatenate([tri.e1, zp]),
            e2=jnp.concatenate([tri.e2, zp]),
        )
    ids = jnp.arange(n_blocks * block, dtype=jnp.int32)
    return tri, ids, n_blocks


def nearest_hit_brute(
    tri: TriangleSoA,
    o: jnp.ndarray,
    d: jnp.ndarray,
    eps: float = 1e-8,
    block: int = 512,
) -> Hit:
    """Nearest hit of rays [R,3] against all T triangles, scanning over
    triangle blocks to bound the [R, block] intermediate."""
    tri_p, ids, n_blocks = _pad_tris(tri, block)
    v0 = tri_p.v0.reshape(n_blocks, block, 3)
    e1 = tri_p.e1.reshape(n_blocks, block, 3)
    e2 = tri_p.e2.reshape(n_blocks, block, 3)
    ids = ids.reshape(n_blocks, block)
    ob = o[:, None, :]
    db = d[:, None, :]

    def body(carry, blk):
        best_t, best_i = carry
        bv0, be1, be2, bid = blk
        t, _ = moller_trumbore(ob, db, TriangleSoA(bv0, be1, be2),
                               best_t[:, None], eps)
        j = jnp.argmin(t, axis=1)
        tj = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
        better = tj < best_t
        best_t = jnp.where(better, tj, best_t)
        best_i = jnp.where(better, bid[j], best_i)
        return (best_t, best_i), None

    init = (jnp.full(o.shape[0], INF, dtype=o.dtype),
            jnp.zeros(o.shape[0], dtype=jnp.int32))
    (t, i), _ = jax.lax.scan(body, init, (v0, e1, e2, ids))
    return Hit(t=t, tri=i, hit=jnp.isfinite(t))


def any_hit_brute(
    tri: TriangleSoA,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_max=INF,
    eps: float = 1e-8,
    block: int = 512,
) -> jnp.ndarray:
    """Occlusion query: does any triangle intersect ray (o, d) with
    eps < t < t_max?  (The reference's shadow walk, main.rs:176-234, with
    t_max = +inf.) Returns bool [R]."""
    tri_p, _, n_blocks = _pad_tris(tri, block)
    v0 = tri_p.v0.reshape(n_blocks, block, 3)
    e1 = tri_p.e1.reshape(n_blocks, block, 3)
    e2 = tri_p.e2.reshape(n_blocks, block, 3)
    ob = o[:, None, :]
    db = d[:, None, :]
    tm = jnp.broadcast_to(jnp.asarray(t_max, dtype=o.dtype), (o.shape[0],))

    def body(occluded, blk):
        bv0, be1, be2 = blk
        _, valid = moller_trumbore(ob, db, TriangleSoA(bv0, be1, be2),
                                   tm[:, None], eps)
        return occluded | jnp.any(valid, axis=1), None

    init = jnp.zeros(o.shape[0], dtype=bool)
    occ, _ = jax.lax.scan(body, init, (v0, e1, e2))
    return occ
