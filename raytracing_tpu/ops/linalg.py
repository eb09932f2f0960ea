"""Small-vector math on trailing-dim-3 arrays.

Replaces glam's Vec3 (reference dep) and the hand-rolled SoA AVX helpers
`avx_multi_cross` / `avx_multi_dot` / etc. (`/root/reference/src/simd_accel.rs:
110-245`). Everything here is shape-polymorphic over leading batch dims and
differentiable; XLA vectorizes and fuses it.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis, keepdims dropped."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3-vector cross product (expanded for clean fusion)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def norm(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Normalize over trailing axis. With eps>0, guards the zero vector."""
    n2 = jnp.sum(a * a, axis=-1, keepdims=True)
    if eps:
        n2 = jnp.maximum(n2, eps)
    return a / jnp.sqrt(n2)


def safe_reciprocal(a: jnp.ndarray) -> jnp.ndarray:
    """1/a with +/-inf for zero components (matches glam's `recip`, used for
    the precomputed reciprocal ray direction in slab tests, `objects.rs:
    64-74`). IEEE division already yields inf; named for intent."""
    return 1.0 / a
