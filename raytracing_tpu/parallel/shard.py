"""Multi-device scaling: shard the ray work, replicate the scene.

The reference's only parallelism is a rayon thread pool over scanlines
(/root/reference/src/main.rs:317-319) inside one process. Here (SURVEY.md
§2.8): a 1-D `jax.sharding.Mesh` over the devices (every card of a host
reaches every other at the same rate, so the mesh follows the algorithm
alone; it extends to multiple hosts via jax.distributed), ray work sharded
along the "rays" axis with `shard_map`, geometry/BVH/materials replicated,
and — for inverse rendering — parameter gradients `pmean`-ed across the
mesh so every device steps identically. Rays are independent, so the
forward pass needs zero cross-device traffic; the only collectives are the
gradient/loss reductions.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import PartitionSpec as P
from jax import shard_map

from raytracing_tpu.accel.packets import ClusterAccel
from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Mesh, Scene
from raytracing_tpu.models.whitted import render_rays

RAY_AXIS = "rays"


def make_device_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """1-D mesh over the first n devices (all by default)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return DeviceMesh(np.asarray(devs), (RAY_AXIS,))


def _pad_to(x: jnp.ndarray, m: int) -> jnp.ndarray:
    pad = (-x.shape[0]) % m
    if pad:
        x = jnp.concatenate([x, jnp.broadcast_to(x[-1:], (pad,) + x.shape[1:])])
    return x


def render_sharded(
    scene: Scene,
    config: RenderConfig,
    device_mesh: DeviceMesh,
    accel: Optional[ClusterAccel] = None,
    key: Optional[jax.Array] = None,
    gi_accel: Optional[ClusterAccel] = None,
) -> jnp.ndarray:
    """Full-frame render with the frame's chunk programs spread across the
    mesh.

    Runs exactly `whitted.render`'s chunk decomposition (same ray order,
    same per-chunk RNG keys, same per-chunk program), with chunk i on
    device i // (chunks per device); geometry, accel(s) and lights are
    replicated. So the image equals the single-device render up to
    floating-point differences between two compilations of the same
    program. Carries the FULL frame capability: area lights and an
    optional coarse gi_accel."""
    from raytracing_tpu.models.whitted import _auto_gi_accel, frame_program

    if key is None:
        key = jax.random.PRNGKey(0)
    if gi_accel is None:
        gi_accel = _auto_gi_accel(scene.mesh, accel, config)
    prog = frame_program(scene, config, accel, gi_accel)
    n_dev = device_mesh.devices.size
    nc_pad = -(-prog.nc // n_dev) * n_dev
    # Padding chunks repeat the last chunk; their rows are dropped.
    ids = jnp.minimum(jnp.arange(nc_pad, dtype=jnp.int32), prog.nc - 1)
    keys = _pad_to(jax.random.split(key, prog.nc), n_dev)
    fn = _sharded_render_fn(prog, device_mesh)
    rgb = fn(ids, keys)[:prog.nc * prog.chunk]
    return prog.finish(rgb)


# jit executable cache for render_sharded: a fresh jax.jit(shard_map(...))
# wrapper per call would start with an EMPTY jit cache, so every frame of
# an animate loop would re-trace and re-enter XLA compile. Keyed like the
# single-device chunk-body cache (whitted._cached_body) plus the mesh's
# device tuple; entries keep the captured objects alive so their ids
# cannot be recycled.
_SHARDED_FN_CACHE: dict = {}


def _sharded_render_fn(prog, device_mesh: DeviceMesh):
    cache_key = (prog.cache_key, tuple(device_mesh.devices.flat))
    hit = _SHARDED_FN_CACHE.get(cache_key)
    if hit is not None:
        return hit[0]
    body = prog.make_body()

    def local(ids_l, keys_l):
        rgb = jax.lax.map(lambda a: body(a[0], a[1]), (ids_l, keys_l))
        return rgb.reshape(-1, 3)

    # jit-of-shard_map: an EAGER shard_map call re-traces and re-compiles
    # on every invocation; under jit the executable is cached (and lands
    # in the persistent compilation cache).
    fn = jax.jit(shard_map(
        local,
        mesh=device_mesh,
        in_specs=(P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    ))
    _SHARDED_FN_CACHE[cache_key] = (fn, prog.refs)
    return fn


def make_train_step(
    config: RenderConfig,
    optimizer: Any,
    device_mesh: DeviceMesh,
    loss_weights: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> Callable:
    """Build a pjit-able inverse-rendering training step.

    params: dict of differentiable scene parameters (any subset of
    {"verts", "colors", "materials"}); the step renders the sharded ray
    batch against a (sharded) target image, takes the L2 pixel loss, pmean's
    gradients over the ray axis, and applies the optax update identically on
    every device — the `psum`-overlapped-with-backward data-parallel recipe
    of BASELINE config 4/5.

    Returned step signature:
      step(params, opt_state, static_mesh, accel, sun, o, d, target, key)
        -> (params, opt_state, loss)
    with o/d/target sharded on the ray axis, everything else replicated.
    """

    def local_step(params, opt_state, base_mesh: Mesh, accel, sun, o, d,
                   target, key):
        key = jax.random.fold_in(key, jax.lax.axis_index(RAY_AXIS))

        def loss_fn(p):
            m = base_mesh._replace(**p)
            rgb = render_rays(m, accel, sun, o, d, key, config)
            return jnp.mean((rgb - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.lax.pmean(grads, RAY_AXIS)
        loss = jax.lax.pmean(loss, RAY_AXIS)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    # jit-of-shard_map (see render_sharded): without the jit wrapper every
    # step() call re-traces and re-compiles — 6 optimizer steps cost 6
    # full compiles.
    return jax.jit(shard_map(
        local_step,
        mesh=device_mesh,
        in_specs=(P(), P(), P(), P(), P(), P(RAY_AXIS), P(RAY_AXIS),
                  P(RAY_AXIS), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    ))
