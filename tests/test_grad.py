"""Differentiability tests — the north-star capability the reference lacks.

Gradients flow through the continuous intersection/shading math (t, normals,
colors, materials) with traversal decisions detached (SURVEY.md §7 item 6).
Validated against central finite differences on configurations where the
discrete hit structure is stable under the probe size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu.accel.packets import build_cluster_accel
from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Scene, concat_objects
from raytracing_tpu.models.whitted import render_rays

CFG = RenderConfig(
    width=8, height=8, samples_per_pixel=1, backend="bruteforce",
    reflect_depth=1, diffuse_depth=1, normals="geometric",
)


def _tri_scene():
    """One large triangle facing the camera, lit from the camera side."""
    obj = {
        "verts": np.array(
            [[-2.0, -2.0, 5.0], [3.0, -2.0, 5.0], [-2.0, 3.0, 5.0]],
            dtype=np.float32,
        ),
        # winding chosen so the face normal is (0,0,-1): toward the camera
        # and the sun (the backface cheat, main.rs:189, needs n·sun > 0)
        "tri_v": np.array([[0, 2, 1]], dtype=np.int32),
        "colors": np.array([0.8, 0.6, 0.4], dtype=np.float32),
        "material": (1.0, 0.0, 0.5),
    }
    mesh = concat_objects([obj])
    return Scene(mesh=mesh, sun=jnp.array([200.0, 300.0, -1000.0]))


def _rays(n=16):
    # Rays through the triangle interior, well away from edges.
    xs = np.linspace(-0.1, 0.15, n).astype(np.float32)
    o = np.zeros((n, 3), dtype=np.float32)
    d = np.stack([xs, xs * 0.5 + 0.02, np.ones(n, np.float32)], axis=-1)
    return jnp.asarray(o), jnp.asarray(d)


def _loss(mesh, scene, o, d, cfg=CFG):
    rgb = render_rays(mesh, None, scene.sun, o, d, jax.random.PRNGKey(0), cfg)
    return jnp.sum(rgb * jnp.array([0.3, 0.5, 0.2]))


def test_grad_verts_finite_nonzero():
    scene = _tri_scene()
    o, d = _rays()
    g = jax.grad(lambda v: _loss(scene.mesh._replace(verts=v), scene, o, d))(
        scene.mesh.verts
    )
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 1e-6


def test_grad_verts_matches_fd():
    scene = _tri_scene()
    o, d = _rays()
    loss = lambda v: _loss(scene.mesh._replace(verts=v), scene, o, d)
    g = np.asarray(jax.grad(loss)(scene.mesh.verts))
    v0 = np.asarray(scene.mesh.verts)
    h = 1e-3
    rng = np.random.default_rng(0)
    for _ in range(4):
        i, k = rng.integers(0, v0.shape[0]), rng.integers(0, 3)
        vp, vm = v0.copy(), v0.copy()
        vp[i, k] += h
        vm[i, k] -= h
        fd = (float(loss(jnp.asarray(vp))) - float(loss(jnp.asarray(vm)))) / (
            2 * h
        )
        np.testing.assert_allclose(g[i, k], fd, rtol=5e-2, atol=1e-5)


def test_grad_materials_matches_fd():
    scene = _tri_scene()
    o, d = _rays()
    loss = lambda m: _loss(scene.mesh._replace(materials=m), scene, o, d)
    g = np.asarray(jax.grad(loss)(scene.mesh.materials))
    m0 = np.asarray(scene.mesh.materials)
    h = 1e-3
    for k in range(2):  # albedo, reflectivity (roughness inert at depth 1)
        mp, mm = m0.copy(), m0.copy()
        mp[0, k] += h
        mm[0, k] -= h
        fd = (float(loss(jnp.asarray(mp))) - float(loss(jnp.asarray(mm)))) / (
            2 * h
        )
        np.testing.assert_allclose(g[0, k], fd, rtol=5e-2, atol=1e-6)


def test_grad_colors_matches_fd():
    scene = _tri_scene()
    o, d = _rays()
    loss = lambda c: _loss(scene.mesh._replace(colors=c), scene, o, d)
    g = np.asarray(jax.grad(loss)(scene.mesh.colors))
    c0 = np.asarray(scene.mesh.colors)
    h = 1e-3
    cp, cm = c0.copy(), c0.copy()
    cp[0, 1] += h
    cm[0, 1] -= h
    fd = (float(loss(jnp.asarray(cp))) - float(loss(jnp.asarray(cm)))) / (2 * h)
    np.testing.assert_allclose(g[0, 1], fd, rtol=2e-2)


def test_grad_through_reflection_and_diffuse():
    """Gradients stay finite through the full multi-level wavefront
    (reflection chain + stochastic diffuse fan-out)."""
    scene = _tri_scene()
    o, d = _rays(8)
    cfg = dataclasses.replace(CFG, reflect_depth=3, diffuse_depth=2,
                              diffuse_scatter=4)
    mats = jnp.asarray(
        np.array([[1.0 / np.pi, 0.5, 0.5]], dtype=np.float32)
    )
    mesh = scene.mesh._replace(materials=mats)
    g = jax.grad(
        lambda v: _loss(mesh._replace(verts=v), scene, o, d, cfg)
    )(mesh.verts)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 1e-8


def test_grad_cluster_backend_matches_brute():
    scene = _tri_scene()
    o, d = _rays()
    accel = build_cluster_accel(scene.mesh, cluster_size=128)
    cfg_c = dataclasses.replace(CFG, backend="cluster")
    gb = jax.grad(lambda v: _loss(scene.mesh._replace(verts=v), scene, o, d))(
        scene.mesh.verts
    )
    gc = jax.grad(
        lambda v: jnp.sum(
            render_rays(scene.mesh._replace(verts=v), accel, scene.sun, o, d,
                        jax.random.PRNGKey(0), cfg_c)
            * jnp.array([0.3, 0.5, 0.2])
        )
    )(scene.mesh.verts)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(gc), rtol=1e-4,
                               atol=1e-7)


def test_grad_pallas_backend_matches_brute():
    """The pallas backend (walk kernel in the interpreter, lazy-t VJP for
    vertices, shading attributes gathered from the live tables) must
    reproduce the bruteforce backend's gradients for every parameter
    table."""
    scene = _tri_scene()
    o, d = _rays()
    accel = build_cluster_accel(scene.mesh, cluster_size=8)
    cfg_p = dataclasses.replace(CFG, backend="pallas", interpret=True)

    def loss_with(backend_cfg, acc):
        def f(verts, colors, materials):
            mesh = scene.mesh._replace(
                verts=verts, colors=colors, materials=materials)
            rgb = render_rays(mesh, acc, scene.sun, o, d,
                              jax.random.PRNGKey(0), backend_cfg)
            return jnp.sum(rgb * jnp.array([0.3, 0.5, 0.2]))
        return f

    args = (scene.mesh.verts, scene.mesh.colors, scene.mesh.materials)
    gb = jax.grad(loss_with(CFG, None), argnums=(0, 1, 2))(*args)
    gp = jax.grad(loss_with(cfg_p, accel), argnums=(0, 1, 2))(*args)
    for b, p, name in zip(gb, gp, ("verts", "colors", "materials")):
        np.testing.assert_allclose(np.asarray(b), np.asarray(p), rtol=2e-4,
                                   atol=1e-7, err_msg=name)
