"""Inverse rendering: fit scene parameters to a target image by gradient
descent through the renderer — BASELINE config 4's "inverse-rendering fit of
pose + vertices", a capability the Rust reference cannot express at all.

Parameters live in a flat dict, any subset of:
  "verts"     [V, 3]  vertex positions
  "colors"    [T, 3]  per-triangle albedo colors
  "materials" [O, 3]  (albedo/π, reflectivity, roughness)
  "pose"      [6]     axis-angle + translation applied to `pose_obj`'s verts

Traversal decisions are detached (SURVEY.md §7), so convergence relies on
the continuous shading/intersection gradients; for large pose errors use
multi-resolution or re-trace (the accel rebuild is host-side and cheap).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import optax

from raytracing_tpu.accel.packets import ClusterAccel, build_cluster_accel
from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Mesh, Scene
from raytracing_tpu.geometry.transform import apply_pose
from raytracing_tpu.models.camera import camera_rays
from raytracing_tpu.models.whitted import render_rays


def apply_params(mesh: Mesh, params: Dict[str, jnp.ndarray],
                 pose_obj: int = 0) -> Mesh:
    direct = {k: v for k, v in params.items() if k != "pose"}
    mesh = mesh._replace(**direct)
    if "pose" in params:
        mesh = apply_pose(mesh, params["pose"], pose_obj)
    return mesh


@dataclasses.dataclass
class FitResult:
    params: Dict[str, jnp.ndarray]
    losses: list


def fit(
    scene: Scene,
    target: jnp.ndarray,
    params: Dict[str, jnp.ndarray],
    config: RenderConfig,
    accel: Optional[ClusterAccel] = None,
    steps: int = 100,
    rays_per_step: int = 4096,
    learning_rate: float = 1e-2,
    pose_obj: int = 0,
    optimizer: Optional[optax.GradientTransformation] = None,
    key: Optional[jax.Array] = None,
    callback: Optional[Callable[[int, float], None]] = None,
    rebuild_every: int = 0,
    retries: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
) -> FitResult:
    """Stochastic inverse rendering: every step samples a random batch of
    primary rays, renders them with the current parameters, and descends the
    L2 loss against the target image's corresponding pixels.

    Accel freshness: shading reads the live color/material/normal tables
    on every backend, but geometry (verts/pose) goes stale in the accel's
    BOUNDS and triangle blocks; set rebuild_every=k (>0) to host-rebuild
    the structure every k steps when fitting geometry with an accel
    backend (the standard refit contract, see ClusterAccel).

    Elastic recovery: retries>0 runs every step through
    utils.resilience.with_retry (transient XLA runtime faults are
    retried with backoff); with checkpoint_path set, unrecoverable
    device loss snapshots (params, opt_state, step) there before
    raising DeviceLost, and checkpoint_every=k also snapshots every k
    steps — a restarted process resumes via utils.checkpoint.load /
    `fit --resume` (SURVEY.md §5: the reference has no persistence)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    opt = optimizer or optax.adam(learning_rate)
    opt_state = opt.init(params)

    geo_params = bool({"verts", "pose"} & set(params))

    o_all, d_all = camera_rays(config)
    spp, h, w = o_all.shape[:3]
    o_all = o_all.reshape(-1, 3)
    d_all = d_all.reshape(-1, 3)
    # Target pixel per primary ray (samples of one pixel share the target).
    tgt_flat = jnp.broadcast_to(target.reshape(1, h * w, 3),
                                (spp, h * w, 3)).reshape(-1, 3)

    @jax.jit
    def step_fn(params, opt_state, key_s, accel_s):
        k_sel, k_render = jax.random.split(key_s)
        idx = jax.random.randint(k_sel, (rays_per_step,), 0, o_all.shape[0])
        o, d, tgt = o_all[idx], d_all[idx], tgt_flat[idx]

        def loss_fn(p):
            mesh = apply_params(scene.mesh, p, pose_obj)
            rgb = render_rays(mesh, accel_s, scene.sun, o, d, k_render,
                              config)
            return jnp.mean((rgb - tgt) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    supervisor = None
    if retries > 0 or checkpoint_path:
        from raytracing_tpu.utils.resilience import Supervisor

        # The closure reads the loop's live (params, opt_state) bindings
        # at snapshot time — always the latest completed step.
        # retries=0 with a checkpoint_path is a legitimate ask (fail fast,
        # snapshot on failure, let an outer scheduler restart) — honor it.
        supervisor = Supervisor(
            checkpoint_path or "fit_recovery.npz",
            state_fn=lambda: {"params": params, "opt_state": opt_state},
            retries=retries, checkpoint_every=checkpoint_every)

    losses = []
    for i in range(steps):
        if (accel is not None and geo_params and rebuild_every > 0
                and i > 0 and i % rebuild_every == 0):
            mesh_i = apply_params(
                scene.mesh,
                {k: jax.lax.stop_gradient(v) for k, v in params.items()},
                pose_obj)
            accel = build_cluster_accel(mesh_i, accel.cluster_size)
        key, ks = jax.random.split(key)
        if supervisor is None:
            params, opt_state, loss = step_fn(params, opt_state, ks, accel)
        else:
            # block inside the retry barrier: device faults surface at
            # materialization, not dispatch.
            params, opt_state, loss = supervisor.run_step(
                lambda: jax.block_until_ready(
                    step_fn(params, opt_state, ks, accel)))
        losses.append(float(loss))
        if callback:
            callback(i, losses[-1])
    return FitResult(params=params, losses=losses)
