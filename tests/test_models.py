"""Tests for the path-tracer and inverse-rendering model families and the
differentiable pose transform."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Scene, concat_objects
from raytracing_tpu.geometry.transform import apply_pose, rotation_matrix
from raytracing_tpu.models import inverse, path_tracer
from raytracing_tpu.models.path_tracer import PathTracerConfig, trace_paths
from raytracing_tpu.models.whitted import render_rays

CFG = RenderConfig(width=8, height=8, samples_per_pixel=1,
                   backend="bruteforce", chunk_size=64)


def _mirror_floor_scene():
    mirror = {
        "verts": np.array(
            [[-10, 0, -10], [-10, 0, 10], [10, 0, 10], [10, 0, -10]],
            dtype=np.float32,
        ),
        "tri_v": np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32),
        "normals": np.array([[0, 1, 0], [0, 1, 0]], dtype=np.float32),
        "colors": np.array([0.0, 0.0, 0.0], dtype=np.float32),
        "material": (0.0, 0.8, 0.0),  # pure mirror
    }
    return Scene(mesh=concat_objects([mirror]),
                 sun=jnp.array([0.0, -1000.0, 0.0]))


def _diffuse_floor_scene():
    floor = {
        "verts": np.array(
            [[-50, 0, -50], [-50, 0, 50], [50, 0, 50], [50, 0, -50]],
            dtype=np.float32,
        ),
        "tri_v": np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32),
        "normals": np.array([[0, 1, 0], [0, 1, 0]], dtype=np.float32),
        "colors": np.array([0.6, 0.7, 0.8], dtype=np.float32),
        "material": (1.0, 0.0, 0.9),
    }
    return Scene(mesh=concat_objects([floor]),
                 sun=jnp.array([0.0, 1000.0, 0.0]))


def test_path_tracer_matches_whitted_on_deterministic_paths():
    """Pure-mirror scene: both integrators follow the identical reflection
    chain (no stochastic branch), so radiance must match exactly."""
    scene = _mirror_floor_scene()
    o = jnp.array([[0.0, 1.0, 0.0], [0.5, 2.0, 0.0]])
    d = jnp.array([[0.1, -1.0, 0.0], [-0.2, -1.0, 0.3]])
    key = jax.random.PRNGKey(1)
    cfg = dataclasses.replace(CFG, diffuse_depth=1, reflect_depth=4)
    whitted = render_rays(scene.mesh, None, scene.sun, o, d, key, cfg)
    pt = trace_paths(scene.mesh, None, scene.sun, o, d, key, cfg,
                     PathTracerConfig(max_bounces=4))
    from raytracing_tpu.ops.color import gamma_correct

    np.testing.assert_allclose(np.asarray(gamma_correct(pt)),
                               np.asarray(whitted), atol=1e-5)


def test_path_tracer_expectation_matches_whitted_diffuse():
    """Diffuse floor: the PT estimator's mean over many samples must agree
    with the Whitted diffuse fan (same BRDF convention) within MC noise."""
    scene = _diffuse_floor_scene()
    o = jnp.array([[0.0, 1.0, 0.0]])
    d = jnp.array([[0.05, -1.0, 0.02]])
    cfg = dataclasses.replace(CFG, diffuse_scatter=512, reflect_depth=2,
                              diffuse_depth=2)
    whitted = np.asarray(
        render_rays(scene.mesh, None, scene.sun, o, d, jax.random.PRNGKey(0),
                    cfg)
    )[0]
    n_samp = 512
    ob = jnp.broadcast_to(o, (n_samp, 3))
    db = jnp.broadcast_to(d, (n_samp, 3))
    pt_cfg = PathTracerConfig(max_bounces=2)
    # trace_paths draws per-ray randomness (uniform/hemisphere samples are
    # shaped [R]), so a batch of identical rays yields independent paths —
    # one batched trace replaces 512 vmapped single-ray programs (~45 s of
    # this test's cost was that vmap).
    samples = trace_paths(scene.mesh, None, scene.sun, ob, db,
                          jax.random.PRNGKey(7), cfg, pt_cfg)
    from raytracing_tpu.ops.color import gamma_correct

    pt_mean = np.asarray(gamma_correct(jnp.mean(samples, axis=0)))
    np.testing.assert_allclose(pt_mean, whitted, rtol=0.06, atol=0.02)


def test_path_tracer_full_frame_runs():
    scene = _diffuse_floor_scene()
    img = path_tracer.render(
        scene, CFG, PathTracerConfig(max_bounces=2, samples_per_pixel=2)
    )
    a = np.asarray(img)
    assert a.shape == (8, 8, 3)
    assert np.isfinite(a).all()


def test_rotation_matrix():
    R = np.asarray(rotation_matrix(jnp.array([0.0, 0.0, np.pi / 2])))
    np.testing.assert_allclose(R @ np.array([1.0, 0, 0]), [0, 1, 0],
                               atol=1e-6)
    R0 = np.asarray(rotation_matrix(jnp.zeros(3)))
    np.testing.assert_allclose(R0, np.eye(3), atol=1e-7)


def test_apply_pose_matches_numpy(teapot_mesh):
    """apply_pose against a float64 numpy Rodrigues rotation about the
    object centroid: f32 accuracy (the matmuls ask for HIGHEST precision,
    so a GPU does not run them in TF32)."""
    pose = np.array([0.3, -0.2, 0.5, 0.1, -0.4, 0.25])
    moved = np.asarray(apply_pose(teapot_mesh, jnp.asarray(pose, jnp.float32),
                                  obj_index=0).verts)
    v = np.asarray(teapot_mesh.verts, np.float64)
    used = np.zeros(len(v), bool)
    used[np.asarray(teapot_mesh.tri_v).ravel()] = True
    pivot = v[used].mean(axis=0)
    theta = np.linalg.norm(pose[:3])
    k = pose[:3] / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    rot = np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx
    want = np.where(used[:, None], (v - pivot) @ rot.T + pivot + pose[3:], v)
    np.testing.assert_allclose(moved, want, rtol=0, atol=2e-5)


def test_apply_pose_moves_only_target_object():
    a = {
        "verts": np.eye(3, dtype=np.float32),
        "tri_v": np.array([[0, 1, 2]], dtype=np.int32),
        "colors": np.ones(3, dtype=np.float32),
        "material": (1.0, 0.0, 1.0),
    }
    b = {
        "verts": np.eye(3, dtype=np.float32) + 5.0,
        "tri_v": np.array([[0, 1, 2]], dtype=np.int32),
        "colors": np.ones(3, dtype=np.float32),
        "material": (1.0, 0.0, 1.0),
    }
    mesh = concat_objects([a, b])
    pose = jnp.array([0.0, 0.0, 0.0, 1.0, 2.0, 3.0])
    moved = apply_pose(mesh, pose, obj_index=1)
    np.testing.assert_allclose(np.asarray(moved.verts[:3]),
                               np.asarray(mesh.verts[:3]), atol=0)
    np.testing.assert_allclose(
        np.asarray(moved.verts[3:]),
        np.asarray(mesh.verts[3:]) + np.array([1.0, 2.0, 3.0]), atol=1e-6
    )


def test_inverse_fit_recovers_color():
    scene = _diffuse_floor_scene()
    # Drop the floor below the camera (the camera sits at the origin; a
    # floor through y=0 is edge-on and every primary ray misses).
    scene = Scene(
        mesh=scene.mesh._replace(verts=scene.mesh.verts.at[:, 1].add(-2.0)),
        sun=scene.sun,
    )
    cfg = dataclasses.replace(CFG, width=8, height=8, diffuse_depth=1)
    target = np.asarray(
        __import__("raytracing_tpu.models.whitted",
                   fromlist=["render"]).render(scene, cfg)
    )
    # Start from wrong colors; fit should reduce loss substantially.
    params = {"colors": scene.mesh.colors * 0.3}
    res = inverse.fit(
        scene, jnp.asarray(target), params, cfg, steps=48,
        rays_per_step=64, learning_rate=8e-2,
    )
    assert res.losses[-1] < res.losses[0] * 0.25, res.losses[::10]
    # Only triangles actually hit by camera rays receive gradient; assert
    # the visible one recovered its true color (unseen params can't move —
    # the expected behaviour of detached-visibility inverse rendering).
    got = np.asarray(res.params["colors"])
    want = np.asarray(scene.mesh.colors)
    recovered = np.abs(got - want).max(axis=1) < 0.05
    assert recovered.any(), (got, want)
