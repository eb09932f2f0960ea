"""Backend dispatch for scene intersection queries.

One call surface, three engines:
  "bruteforce" — ops/trace.py, the oracle (any device)
  "cluster"    — accel/packets.py, flat cluster hierarchy in pure XLA
                 (slab-culled clusters are masked, not skipped)
  "pallas"     — kernels/traverse.py, the Pallas walk compiled through
                 Triton for a CUDA GPU (block-granular cluster skipping —
                 the reference's early-out traversal, main.rs:93-171)
  "auto"       — "pallas" on a GPU, "cluster" elsewhere

The backend string lives in the static RenderConfig, so the choice is a
trace-time Python branch — zero runtime dispatch under jit.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from raytracing_tpu.accel.packets import (
    ClusterAccel,
    any_hit_cluster,
    nearest_hit_cluster,
)
from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Mesh, triangle_soa
from raytracing_tpu.ops.intersect import INF
from raytracing_tpu.ops.trace import Hit, any_hit_brute, nearest_hit_brute

BACKENDS = ("auto", "bruteforce", "cluster", "pallas")


def resolve_backend(backend: str) -> str:
    """Resolve "auto": the Pallas walk where it compiles (a CUDA GPU, where
    it renders the reference frame faster than the XLA cluster scan — see
    PERF.md), the XLA cluster scan elsewhere. Explicit names pass through
    untouched."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "auto":
        return backend
    return "pallas" if jax.default_backend() == "gpu" else "cluster"


def nearest_hit(
    mesh: Mesh,
    accel: Optional[ClusterAccel],
    o: jnp.ndarray,
    d: jnp.ndarray,
    config: RenderConfig,
    alive: Optional[jnp.ndarray] = None,
) -> Hit:
    """alive: optional [R] bool wavefront mask — dead lanes may carry
    garbage rays; the walk leaves them out of its culling decisions and
    their results are meaningless (callers mask by weight). Dense
    backends ignore it."""
    backend = resolve_backend(config.backend)
    if backend == "bruteforce" or accel is None:
        tri = triangle_soa(mesh.verts, mesh.tri_v)
        return nearest_hit_brute(tri, o, d, config.eps)
    if backend == "cluster":
        return nearest_hit_cluster(mesh, accel, o, d, config.eps)
    from raytracing_tpu.kernels.traverse import nearest_hit_pallas

    return nearest_hit_pallas(mesh, accel, o, d, config.eps, alive=alive,
                              interpret=config.interpret)


def any_hit(
    mesh: Mesh,
    accel: Optional[ClusterAccel],
    o: jnp.ndarray,
    d: jnp.ndarray,
    config: RenderConfig,
    t_max=INF,
    alive: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    backend = resolve_backend(config.backend)
    if backend == "bruteforce" or accel is None:
        tri = triangle_soa(mesh.verts, mesh.tri_v)
        return any_hit_brute(tri, o, d, t_max, config.eps)
    if backend == "cluster":
        return any_hit_cluster(mesh, accel, o, d, t_max, config.eps)
    from raytracing_tpu.kernels.traverse import any_hit_pallas

    return any_hit_pallas(mesh, accel, o, d, config.eps, t_max,
                          alive=alive, interpret=config.interpret)
