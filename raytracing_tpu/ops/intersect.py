"""Ray/primitive intersection math — the framework's innermost loop.

Re-design of the reference's intersection layer:
  * scalar Möller–Trumbore  `Triangle::ray_hits`   (/root/reference/src/objects.rs:273-308)
  * 8-wide AVX2 Möller–Trumbore `PackedTriangles::intersect` (simd_accel.rs:282-331)
  * scalar slab test `box_intersection_check`       (objects.rs:322-333)
  * 8-wide slab test `PackedBoxes::intersect`       (simd_accel.rs:343-377)

Instead of 8 fixed `__m256` lanes, every function here is written on
broadcastable arrays and compiled by XLA — the "lane count" is whatever
batch shape the caller brings. (The Pallas walk, kernels/traverse.py,
computes the same Möller–Trumbore expression in the same operation
order.) Misses are encoded as
t = +inf (the reference encodes them as a -1.0 blend + a sign movemask,
`simd_accel.rs:318-330`; +inf composes directly with min-reductions and
avoids the separate mask word).

All functions are differentiable; the acceptance masks use detached
comparisons so gradients flow only through the continuous t/u/v terms.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from raytracing_tpu.ops.linalg import cross, dot

INF = jnp.inf


class TriangleSoA(NamedTuple):
    """Möller–Trumbore-ready triangle form.

    Mirrors the reference's precompute in `pack_triangles` (simd_accel.rs:
    8-66): store v0 = A and the edge vectors e1 = B - A, e2 = C - A rather
    than raw vertices. Shapes are [..., T, 3].
    """

    v0: jnp.ndarray
    e1: jnp.ndarray
    e2: jnp.ndarray


def moller_trumbore(
    o: jnp.ndarray,
    d: jnp.ndarray,
    tri: TriangleSoA,
    t_max,
    eps: float = 1e-8,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched watertight-ish Möller–Trumbore.

    o, d: [..., 3] ray origins/directions; tri fields [..., 3] — all shapes
    must broadcast against each other (typically o=[R,1,3], tri=[T,3]).
    t_max broadcasts against the result shape.

    Acceptance matches the 8-wide reference kernel (simd_accel.rs:305-317):
    fail iff |det| < eps  ∨  u < 0 ∨ v < 0 ∨ u + v > 1 ∨ t <= eps ∨ t >= t_max.
    (The scalar reference additionally uses u > 1 which is implied by
    u + v > 1 with v >= 0.)

    Returns (t, valid): t = +inf where invalid.
    """
    pvec = cross(d, tri.e2)
    det = dot(tri.e1, pvec)
    # No early-out branches: all lanes compute; the mask kills bad
    # lanes. The division is taken against a mask-safe det: a raw 1/0 = inf
    # would be fine forward (masked) but poisons reverse-mode with 0*inf
    # NaNs through the product-rule cotangents — the where() must be
    # *inside* the division, the standard JAX safe-grad idiom.
    safe_det = jnp.where(jnp.abs(det) >= eps, det, 1.0)
    inv_det = 1.0 / safe_det
    s = o - tri.v0
    u = dot(s, pvec) * inv_det
    qvec = cross(s, tri.e1)
    v = dot(d, qvec) * inv_det
    t = dot(tri.e2, qvec) * inv_det
    valid = (
        (jnp.abs(det) >= eps)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > eps)
        & (t < t_max)
    )
    return jnp.where(valid, t, INF), valid


def slab_test(
    o: jnp.ndarray,
    inv_d: jnp.ndarray,
    box_min: jnp.ndarray,
    box_max: jnp.ndarray,
    t_max,
) -> jnp.ndarray:
    """Batched ray/AABB slab test. Shapes broadcast; returns bool mask.

    Uses the standard tight predicate t_near <= min(t_far, t_max) ∧ t_far >= 0
    — the 8-wide reference kernel's semantics (simd_accel.rs:343-377), not the
    loose scalar variant `t_near.min(0) <= t_far` (objects.rs:332) which
    admits false positives (documented in SURVEY.md §2.1).
    """
    t1 = (box_min - o) * inv_d
    t2 = (box_max - o) * inv_d
    # min/max propagate the correct slab ordering without the reference's
    # sign-mask conditional-swap table (simd_accel.rs:333-340): jnp.minimum
    # on (a, b) and (b, a) is the branchless swap.
    t_near = jnp.max(jnp.minimum(t1, t2), axis=-1)
    t_far = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return (t_near <= jnp.minimum(t_far, t_max)) & (t_far >= 0.0)


def ray_sphere(
    o: jnp.ndarray,
    d: jnp.ndarray,
    center: jnp.ndarray,
    radius,
    t_max,
    eps: float = 1e-8,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched ray/sphere (near root only) — parity with the reference's
    `Sphere::ray_hits` (objects.rs:247-271), which is present but unused in
    its scene. Returns (t, valid), t=+inf on miss."""
    oc = o - center
    a = dot(d, d)
    half_b = dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t = (-half_b - sq) / jnp.where(jnp.abs(a) >= eps, a, 1.0)
    valid = (disc > 0.0) & (t > eps) & (t < t_max)
    return jnp.where(valid, t, INF), valid


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection r = d - 2 n (d·n)  (main.rs:245)."""
    return d - 2.0 * n * dot(d, n)[..., None]


def triangle_normal(va, vb, vc, eps: float = 1e-20) -> jnp.ndarray:
    """Geometric face normal normalize(cross(b-a, c-a)) — the reference's
    `calculate_normal` (objects.rs:5-7), differentiable w.r.t. vertices."""
    n = cross(vb - va, vc - va)
    n2 = jnp.sum(n * n, axis=-1, keepdims=True)
    return n / jnp.sqrt(jnp.maximum(n2, eps))
