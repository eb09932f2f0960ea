"""Multi-device tests over the virtual 8-device CPU mesh (see conftest)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from raytracing_tpu.accel.packets import build_cluster_accel
from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Scene, concat_objects
from raytracing_tpu.models.whitted import render, render_rays
from raytracing_tpu.parallel.shard import (
    make_device_mesh,
    make_train_step,
    render_sharded,
)


def _small_scene():
    obj = {
        "verts": np.array(
            [[-2.0, -2.0, 5.0], [3.0, -2.0, 5.0], [-2.0, 3.0, 5.0],
             [2.5, 2.5, 6.0], [4.0, 2.5, 6.0], [2.5, 4.0, 6.0]],
            dtype=np.float32,
        ),
        "tri_v": np.array([[0, 2, 1], [3, 5, 4]], dtype=np.int32),
        "colors": np.array([0.8, 0.6, 0.4], dtype=np.float32),
        "material": (1.0, 0.2, 0.5),
    }
    return Scene(mesh=concat_objects([obj]),
                 sun=jnp.array([200.0, 300.0, -1000.0]))


CFG = RenderConfig(width=16, height=16, samples_per_pixel=1,
                   backend="bruteforce", chunk_size=32,
                   reflect_depth=2, diffuse_depth=1)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single_device():
    scene = _small_scene()
    dmesh = make_device_mesh(8)
    key = jax.random.PRNGKey(5)
    img_s = np.asarray(render_sharded(scene, CFG, dmesh, key=key))
    # Single-device reference with per-shard key folding reproduced: the
    # deterministic parts (geometry) must match exactly; RNG-dependent parts
    # are absent at diffuse_depth=1.
    img_1 = np.asarray(render(scene, CFG, key=key))
    np.testing.assert_allclose(img_s, img_1, atol=1e-5)


def test_train_step_runs_and_reduces_loss():
    scene = _small_scene()
    dmesh = make_device_mesh(8)
    # reflect_depth=1: a single wavefront level. The value_and_grad of
    # even one level under shard_map over 8 virtual devices is minutes of
    # XLA CPU compile (it was ~10 min at reflect_depth=2 — 46% of the
    # whole suite); multi-level gradients are covered single-device in
    # test_grad.py and the multi-level shard_map forward in
    # test_sharded_render_*; the collectives this test exists for are
    # depth-independent.
    cfg = dataclasses.replace(CFG, normals="geometric", reflect_depth=1)
    opt = optax.adam(1e-2)
    step = make_train_step(cfg, opt, dmesh)

    # Target: render of the true scene; start from perturbed vertices.
    n = 64
    xs = np.linspace(-0.15, 0.15, n).astype(np.float32)
    o = jnp.zeros((n, 3))
    d = jnp.stack([jnp.asarray(xs), jnp.asarray(xs) * 0.3 + 0.02,
                   jnp.ones(n)], axis=-1)
    key = jax.random.PRNGKey(0)
    target = render_rays(scene.mesh, None, scene.sun, o, d, key, cfg)

    v_true = scene.mesh.verts
    params = {"verts": v_true + 0.05}
    opt_state = opt.init(params)
    losses = []
    for i in range(6):
        params, opt_state, loss = step(
            params, opt_state, scene.mesh, None, scene.sun, o, d, target, key
        )
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses


def test_gradients_replicated_across_devices():
    """pmean'd grads must be identical on every device (replicated out)."""
    scene = _small_scene()
    dmesh = make_device_mesh(8)
    opt = optax.sgd(0.0)
    step = make_train_step(CFG, opt, dmesh)
    n = 64
    o = jnp.zeros((n, 3))
    d = jnp.stack([jnp.linspace(-0.1, 0.1, n), jnp.zeros(n) + 0.02,
                   jnp.ones(n)], axis=-1)
    target = jnp.zeros((n, 3))
    params = {"colors": scene.mesh.colors}
    params, _, loss = step(params, opt.init(params), scene.mesh, None,
                           scene.sun, o, d, target, jax.random.PRNGKey(0))
    assert np.isfinite(float(loss))
    # Pull each device's copy and compare.
    c = params["colors"]
    shards = [np.asarray(s.data) for s in c.addressable_shards]
    for s in shards[1:]:
        np.testing.assert_array_equal(shards[0], s)


def test_sharded_render_pallas_kernels():
    """The PALLAS walk (in the interpreter on CPU devices) under
    shard_map — visit-list culling + walk + rest merge all run inside the
    sharded region, per device shard, so the sharded tests exercise the
    real kernel and not only the bruteforce stand-in."""
    from raytracing_tpu.geometry.scene import build_default_scene

    scene = build_default_scene(t=0.0)
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    dmesh = make_device_mesh(8)
    cfg = dataclasses.replace(
        CFG, backend="pallas", interpret=True, chunk_size=64,
        diffuse_depth=0, reflect_depth=1, width=16, height=16)
    key = jax.random.PRNGKey(5)
    img_p = np.asarray(render_sharded(scene, cfg, dmesh, accel=accel,
                                      key=key))
    cfg_b = dataclasses.replace(cfg, backend="bruteforce")
    img_b = np.asarray(render_sharded(scene, cfg_b, dmesh, key=key))
    np.testing.assert_allclose(img_p, img_b, atol=1e-5)


def test_sharded_render_carries_area_lights():
    """render_sharded must thread the scene's area lights (round-2 weak
    #6: the sharded paths silently dropped them). A near-point light
    (radius 1e-6 -> the sample cone collapses to its axis, so the
    estimator is RNG-independent) makes the sharded image comparable to
    the single-device render."""
    from raytracing_tpu.geometry.mesh import SphereLight

    base = _small_scene()
    lights = SphereLight(
        center=jnp.array([[0.0, 2.0, 4.0]], jnp.float32),
        radius=jnp.array([0.5], jnp.float32),
        emission=jnp.array([[5.0, 4.0, 3.0]], jnp.float32),
    )
    lit = Scene(mesh=base.mesh, sun=base.sun, lights=lights)
    dmesh = make_device_mesh(8)
    key = jax.random.PRNGKey(5)
    img_dark = np.asarray(render_sharded(base, CFG, dmesh, key=key))
    img_lit_s = np.asarray(render_sharded(lit, CFG, dmesh, key=key))
    # Lights reached the sharded path: the image must actually change.
    assert np.abs(img_lit_s - img_dark).max() > 1e-3
    # RNG streams differ between the sharded and single-device renders
    # (per-device key folding), so the soft-shadow noise differs sample
    # by sample — compare the added radiance in aggregate instead.
    img_lit_1 = np.asarray(render(lit, CFG, key=key))
    add_s = (img_lit_s - img_dark).mean()
    add_1 = (img_lit_1 - np.asarray(render(base, CFG, key=key))).mean()
    assert add_1 > 1e-4
    np.testing.assert_allclose(add_s, add_1, rtol=0.15)
