"""Differentiable rigid transforms for inverse rendering (pose fitting).

The reference bakes per-object translation into the vertex pool at load
(`read_obj`'s offset, /root/reference/src/main.rs:53). For inverse
rendering (BASELINE config 4: "fit of pose + vertices") pose must stay a
live parameter: a 6-dof (axis-angle rotation + translation) transform
applied differentiably to one object's vertices inside the loss.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracing_tpu.geometry.mesh import Mesh


def rotation_matrix(axis_angle: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula, differentiable at the identity. axis_angle [3]."""
    theta2 = jnp.sum(axis_angle * axis_angle)
    theta = jnp.sqrt(theta2 + 1e-20)
    k = axis_angle / theta
    kx, ky, kz = k[0], k[1], k[2]
    zero = jnp.zeros(())
    K = jnp.stack(
        [
            jnp.stack([zero, -kz, ky]),
            jnp.stack([kz, zero, -kx]),
            jnp.stack([-ky, kx, zero]),
        ]
    )
    eye = jnp.eye(3, dtype=axis_angle.dtype)
    s = jnp.sin(theta)
    c = jnp.cos(theta)
    # HIGHEST: a GPU runs default-precision f32 matmuls in TF32 (~3
    # decimal digits), which would bend rotations and pose gradients.
    R = eye + s * K + (1.0 - c) * jnp.matmul(
        K, K, precision=jax.lax.Precision.HIGHEST)
    # Near theta=0 the formula degrades; blend to first-order I + [w]x.
    small = theta < 1e-5
    R_small = eye + _hat(axis_angle)
    return jnp.where(small, R_small, R)


def _hat(w: jnp.ndarray) -> jnp.ndarray:
    zero = jnp.zeros((), dtype=w.dtype)
    return jnp.stack(
        [
            jnp.stack([zero, -w[2], w[1]]),
            jnp.stack([w[2], zero, -w[0]]),
            jnp.stack([-w[1], w[0], zero]),
        ]
    )


def apply_pose(
    mesh: Mesh,
    pose: jnp.ndarray,
    obj_index: int,
    pivot: jnp.ndarray | None = None,
) -> Mesh:
    """Apply a 6-dof pose [rx, ry, rz, tx, ty, tz] to one object's vertices
    (rotation about the object centroid by default). Returns a new Mesh;
    fully differentiable w.r.t. `pose`."""
    rot = rotation_matrix(pose[:3])
    trans = pose[3:]
    # Which vertices belong to the object: derive the vertex set from its
    # triangles (host-static obj_id -> boolean mask over verts).
    n_verts = mesh.verts.shape[0]
    tri_sel = mesh.obj_id == obj_index
    # Out-of-range sentinel + mode="drop" so unselected triangles scatter
    # nowhere (a -1 sentinel would wrap to the last vertex).
    idx = jnp.where(tri_sel[:, None], mesh.tri_v, n_verts).reshape(-1)
    touched = jnp.zeros(n_verts, dtype=bool).at[idx].set(True, mode="drop")
    if pivot is None:
        w = touched.astype(mesh.verts.dtype)[:, None]
        pivot = jnp.sum(mesh.verts * w, axis=0) / jnp.maximum(w.sum(), 1.0)
    moved = jnp.matmul(mesh.verts - pivot, rot.T,
                       precision=jax.lax.Precision.HIGHEST) + pivot + trans
    verts = jnp.where(touched[:, None], moved, mesh.verts)
    return mesh._replace(verts=verts)
