"""Spherical area lights: soft shadows, backend agreement, gradients."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_tpu.accel.packets import build_cluster_accel
from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Scene, SphereLight
from raytracing_tpu.geometry.scene import (
    build_default_mesh,
    sun_position,
)
from raytracing_tpu.models.whitted import render, render_rays


def _scene(radius):
    mesh = build_default_mesh()
    light = SphereLight(
        center=jnp.array([[1.0, 8.0, 7.0]]),
        radius=jnp.array([radius]),
        emission=jnp.array([[1.5, 1.5, 1.5]]),
    )
    return Scene(mesh=mesh, sun=sun_position(0.0), lights=light)


CFG = RenderConfig(width=40, height=40, samples_per_pixel=1,
                   backend="cluster", reflect_depth=1, diffuse_depth=0,
                   light_samples=8)


def test_soft_shadow_has_penumbra():
    """A fat light must produce intermediate visibility values that a
    near-point light does not (penumbra pixels strictly between the lit
    and fully-shadowed plateaus)."""
    img_soft = np.asarray(render(_scene(2.5), CFG, key=jax.random.PRNGKey(0)))
    img_hard = np.asarray(render(_scene(0.01), CFG, key=jax.random.PRNGKey(0)))
    lum_s = img_soft.mean(axis=-1).ravel()
    lum_h = img_hard.mean(axis=-1).ravel()
    # quantize luminances; the soft render must occupy more distinct
    # brightness levels in the shadowed ground region
    n_levels_soft = len(np.unique(np.round(lum_s, 2)))
    n_levels_hard = len(np.unique(np.round(lum_h, 2)))
    assert n_levels_soft > n_levels_hard, (n_levels_soft, n_levels_hard)


def test_area_light_backends_agree_in_expectation():
    scene = _scene(1.5)
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg_p = CFG.replace(backend="pallas", interpret=True, light_samples=4)
    cfg_b = CFG.replace(backend="bruteforce", light_samples=4)
    ip = np.asarray(render(scene, cfg_p, accel=accel,
                           key=jax.random.PRNGKey(1)))
    ib = np.asarray(render(scene, cfg_b, key=jax.random.PRNGKey(1)))
    # identical RNG + identical ray order => identical estimator values
    np.testing.assert_allclose(ip, ib, atol=2e-6)


def test_light_param_gradients():
    scene = _scene(2.0)
    accel = build_cluster_accel(scene.mesh)

    cfg = CFG.replace(light_samples=4)  # gradient structure is per-sample

    def loss(center, radius, emission):
        l = SphereLight(center=center, radius=radius, emission=emission)
        s = Scene(mesh=scene.mesh, sun=scene.sun, lights=l)
        o = jnp.zeros((64, 3))
        xs = jnp.linspace(-0.4, 0.4, 64)
        d = jnp.stack([xs, xs * 0.1 - 0.25, jnp.ones(64)], axis=-1)
        rgb = render_rays(scene.mesh, accel, scene.sun, o, d,
                          jax.random.PRNGKey(2), cfg, lights=l)
        return jnp.sum(rgb)

    g = jax.grad(loss, argnums=(0, 1, 2))(
        scene.lights.center, scene.lights.radius, scene.lights.emission)
    for gi in g:
        assert np.isfinite(np.asarray(gi)).all()
    assert float(jnp.abs(g[2]).sum()) > 0.0  # emission definitely matters
