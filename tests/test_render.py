"""End-to-end render tests of the Whitted integrator.

The reference validates rendering only by eyeballing the window (SURVEY.md
§4); here the oracle is the brute-force backend plus physical invariants
(sky color, shadowing, energy bounds) and a committed golden image.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_tpu.accel.packets import build_cluster_accel
from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Scene, concat_objects
from raytracing_tpu.geometry.scene import build_default_scene
from raytracing_tpu.models.whitted import render, render_rays

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "teapot32.npy")


def small_cfg(**kw):
    base = dict(width=32, height=32, samples_per_pixel=1, backend="cluster",
                chunk_size=32 * 32)
    base.update(kw)
    return RenderConfig(**base)


# The 32x32 full-depth render costs ~20 s of CPU XLA; render each
# (config, key) at most once per test session and let every invariant
# test share it.
_RENDER_CACHE: dict = {}


def _cached_render(scene, cfg, key_seed, accel=None):
    k = (cfg, key_seed, accel is not None)
    if k not in _RENDER_CACHE:
        _RENDER_CACHE[k] = np.asarray(
            render(scene, cfg, accel=accel, key=jax.random.PRNGKey(key_seed))
        )
    return _RENDER_CACHE[k]


def test_sky_and_bounds(default_scene):
    accel = build_cluster_accel(default_scene.mesh)
    img = _cached_render(default_scene, small_cfg(), 0, accel)
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    sky = (np.array([0x87, 0xCE, 0xEB]) / 255.0) ** (1 / 2.2)
    np.testing.assert_allclose(img[0, 0], sky, atol=1e-3)  # top-left = sky
    assert img.min() >= 0.0
    assert img.max() <= 2.0  # loose energy sanity


def test_backends_agree(default_scene):
    accel = build_cluster_accel(default_scene.mesh)
    a = _cached_render(default_scene, small_cfg(), 0, accel)
    b = _cached_render(default_scene, small_cfg(backend="bruteforce"), 0)
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_golden_image(default_scene):
    accel = build_cluster_accel(default_scene.mesh)
    img = _cached_render(default_scene, small_cfg(), 0, accel)
    if not os.path.exists(GOLDEN):
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        np.save(GOLDEN, img)
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(img, golden, atol=2e-5)


def _blocker_scene():
    """A big ground quad with a small blocker square hovering above; sun
    straight overhead => the region under the blocker is hard-shadowed."""
    ground = {
        "verts": np.array(
            [[-10, 0, -10], [-10, 0, 10], [10, 0, 10], [10, 0, -10]],
            dtype=np.float32,
        ),
        "tri_v": np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32),
        "normals": np.array([[0, 1, 0], [0, 1, 0]], dtype=np.float32),
        "colors": np.array([1.0, 1.0, 1.0], dtype=np.float32),
        "material": (1.0, 0.0, 0.0),  # pure Lambertian, no diffuse bounce
    }
    blocker = {
        "verts": np.array(
            [[-1, 2, -1], [-1, 2, 1], [1, 2, 1], [1, 2, -1]], dtype=np.float32
        ),
        "tri_v": np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32),
        "colors": np.array([1.0, 0.0, 0.0], dtype=np.float32),
        "material": (1.0, 0.0, 0.0),
    }
    mesh = concat_objects([ground, blocker])
    return Scene(mesh=mesh, sun=jnp.array([0.0, 1000.0, 0.0]))


def test_hard_shadows():
    scene = _blocker_scene()
    cfg = small_cfg(backend="bruteforce", reflect_depth=1, diffuse_depth=1)
    # Rays straight down from above the gap and from above the blocked zone
    # (origin y=1 is *below* the blocker so both hit the ground).
    o = jnp.array([[5.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    d = jnp.array([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])
    rgb = np.asarray(
        render_rays(scene.mesh, None, scene.sun, o, d, jax.random.PRNGKey(0),
                    cfg)
    )
    assert rgb[0].sum() > 0.1  # lit ground
    np.testing.assert_allclose(rgb[1], 0.0, atol=1e-6)  # shadowed


def test_reflection_capability():
    """A mirror floor under the sky must show sky color via reflection even
    where direct light is blocked — exercises main.rs:243-257 semantics."""
    mirror = {
        "verts": np.array(
            [[-10, 0, -10], [-10, 0, 10], [10, 0, 10], [10, 0, -10]],
            dtype=np.float32,
        ),
        "tri_v": np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32),
        "normals": np.array([[0, 1, 0], [0, 1, 0]], dtype=np.float32),
        "colors": np.array([0.0, 0.0, 0.0], dtype=np.float32),  # black base
        "material": (0.0, 1.0, 0.0),  # perfect mirror, nothing else
    }
    scene = Scene(mesh=concat_objects([mirror]),
                  sun=jnp.array([0.0, -1000.0, 0.0]))  # sun below: no direct
    cfg = small_cfg(backend="bruteforce", diffuse_depth=1)
    o = jnp.array([[0.0, 1.0, 0.0]])
    d = jnp.array([[0.1, -1.0, 0.0]])
    rgb = np.asarray(
        render_rays(scene.mesh, None, scene.sun, o, d, jax.random.PRNGKey(0),
                    cfg)
    )[0]
    sky = (np.array([0x87, 0xCE, 0xEB]) / 255.0) ** (1 / 2.2)
    np.testing.assert_allclose(rgb, sky, atol=1e-3)


def test_diffuse_gi_brightens_adjacent_surfaces():
    """Diffuse scatter (main.rs:259-299): a white wall next to a lit white
    floor receives bounce light even though the sun grazes it."""
    floor = {
        "verts": np.array(
            [[-5, 0, -5], [-5, 0, 5], [5, 0, 5], [5, 0, -5]], dtype=np.float32
        ),
        "tri_v": np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32),
        "normals": np.array([[0, 1, 0], [0, 1, 0]], dtype=np.float32),
        "colors": np.array([1.0, 1.0, 1.0], dtype=np.float32),
        "material": (1.0, 0.0, 1.0),
    }
    scene = Scene(mesh=concat_objects([floor]),
                  sun=jnp.array([0.0, 1000.0, 0.0]))
    o = jnp.array([[0.0, 1.0, 0.0]])
    d = jnp.array([[0.0, -1.0, 0.0]])
    key = jax.random.PRNGKey(0)
    with_gi = np.asarray(
        render_rays(scene.mesh, None, scene.sun, o, d, key,
                    small_cfg(backend="bruteforce"))
    )[0]
    no_gi = np.asarray(
        render_rays(scene.mesh, None, scene.sun, o, d, key,
                    small_cfg(backend="bruteforce", diffuse_depth=1))
    )[0]
    # GI adds energy: floor sees sky through scattered rays.
    assert with_gi.sum() > no_gi.sum() + 1e-3


def _bumpy_grid_scene(g=16):
    """Compact multi-cluster scene: a g x g bumpy quad grid over a ground
    quad (the floor lands in the dense rest set). Small enough that
    pallas-interpret renders run in seconds, structured enough (many
    clusters at cs=16 AND cs=64, multi-entry visit lists) to exercise the
    same partition logic as the full teapot scene."""
    gx, gz = np.meshgrid(np.arange(g + 1), np.arange(g + 1), indexing="ij")
    gv = np.stack(
        [gx.ravel() - g / 2.0,
         0.4 * np.sin(gx.ravel() * 1.9) * np.cos(gz.ravel() * 1.3) - 1.0,
         gz.ravel() + 3.0], axis=1).astype(np.float32)
    quads = []
    for i in range(g):
        for j in range(g):
            a = i * (g + 1) + j
            quads.append([a, a + g + 1, a + 1])
            quads.append([a + 1, a + g + 1, a + g + 2])
    grid_obj = {"verts": gv, "tri_v": np.asarray(quads, dtype=np.int32),
                "colors": np.array([0.7, 0.5, 0.3], dtype=np.float32),
                "material": (1.0, 0.4, 0.6)}
    floor = {"verts": np.array([[-60, -3, -60], [-60, -3, 60],
                                [60, -3, 60], [60, -3, -60]],
                               dtype=np.float32),
             "tri_v": np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32),
             "colors": np.array([0.5, 0.5, 0.5], dtype=np.float32),
             "material": (1.0, 0.0, 1.0)}
    return Scene(mesh=concat_objects([grid_obj, floor]),
                 sun=jnp.array([1000.0, 2500.0, -500.0]))


def test_gi_accel_parity():
    """A coarse bounce-level accel (gi_accel) must not change the image:
    both accels cover the same triangle set, so every nearest hit, shadow
    verdict, and RNG draw is identical — only the walk partition differs."""
    scene = _bumpy_grid_scene()
    cfg = small_cfg(width=16, height=16, backend="pallas", interpret=True,
                    chunk_size=16 * 16, reflect_depth=1, diffuse_depth=2,
                    diffuse_scatter=2)
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    coarse = build_cluster_accel(scene.mesh, cluster_size=64)
    assert accel.num_clusters >= 4 * coarse.num_clusters >= 16
    # Oracle: the cluster backend (render() keeps RNG/ray order identical
    # across backends, so images match exactly).
    a = np.asarray(render(scene, cfg.replace(backend="cluster"),
                          accel=accel, key=jax.random.PRNGKey(5)))
    b = np.asarray(render(scene, cfg, accel=accel, gi_accel=coarse,
                          key=jax.random.PRNGKey(5)))
    assert np.isfinite(b).all()
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_bin_reflect_levels_knob(default_scene):
    """bin_reflect_levels toggles the pure-reflect levels' re-bin — a
    pure performance knob: the bin permutation is undone before radiance
    accumulation and no RNG is drawn at pure-reflect levels, so the
    image must match exactly."""
    cfg = small_cfg(width=16, height=16, backend="pallas", interpret=True,
                    chunk_size=16 * 16, reflect_depth=3, diffuse_depth=2,
                    diffuse_scatter=2)
    accel = build_cluster_accel(default_scene.mesh, cluster_size=16)
    a = np.asarray(render(default_scene, cfg, accel=accel,
                          key=jax.random.PRNGKey(5)))
    b = np.asarray(render(default_scene,
                          cfg.replace(bin_reflect_levels=False),
                          accel=accel, key=jax.random.PRNGKey(5)))
    assert np.isfinite(b).all()
    np.testing.assert_array_equal(a, b)
