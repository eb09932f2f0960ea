"""Tests for the chunked frame dispatch machinery: formula ray ids,
reshape-only image assembly, payload-sort binning, and mesh subdivision."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_tpu.config import RenderConfig
from raytracing_tpu.kernels.binning import bin_key, bin_sort, unsort
from raytracing_tpu.models.camera import (
    block_permutation,
    block_ray_ids,
    blocks_to_image,
    camera_rays,
    camera_rays_for_ids,
)


def test_block_ray_ids_matches_table():
    cfg = RenderConfig(width=64, height=48, samples_per_pixel=4)
    perm, _ = block_permutation(4, 48, 64, 16, 16)
    r = 4 * 48 * 64
    chunk = 3072
    got = np.concatenate(
        [np.asarray(block_ray_ids(i, chunk, cfg)) for i in range(r // chunk)]
    )
    np.testing.assert_array_equal(got, np.asarray(perm))


def test_block_ray_ids_clamps_padding_tail():
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=1)
    r = 32 * 32
    chunk = 768  # r/chunk = 1.33 -> padded tail in chunk 1
    ids = np.asarray(block_ray_ids(1, chunk, cfg))
    assert ids.max() == r - 1
    assert (ids[r - chunk:] == r - 1).all()


def test_blocks_to_image_inverts_permutation():
    cfg = RenderConfig(width=64, height=48, samples_per_pixel=4)
    perm, _ = block_permutation(4, 48, 64, 16, 16)
    r = 4 * 48 * 64
    vals = np.random.default_rng(0).standard_normal((r, 3)).astype(np.float32)
    packed = vals[np.asarray(perm)]
    img = np.asarray(blocks_to_image(jnp.asarray(packed), cfg))
    want = vals.reshape(4, 48, 64, 3).mean(axis=0)
    np.testing.assert_allclose(img, want, atol=1e-6)


def test_camera_rays_for_ids_matches_camera_rays():
    cfg = RenderConfig(width=40, height=24, samples_per_pixel=4)
    o_all, d_all = camera_rays(cfg)
    r = 4 * 24 * 40
    ids = jnp.arange(r, dtype=jnp.int32)
    o, d = camera_rays_for_ids(ids, cfg)
    np.testing.assert_array_equal(np.asarray(d), np.asarray(d_all).reshape(r, 3))
    np.testing.assert_array_equal(np.asarray(o), np.asarray(o_all).reshape(r, 3))


def test_bin_sort_unsort_roundtrip():
    rng = np.random.default_rng(1)
    n = 512
    o = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    d = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    alive = jnp.asarray(rng.integers(0, 2, n).astype(bool))
    scalar = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    k = bin_key(o, d, jnp.zeros(3), jnp.ones(3), alive)
    sidx, (o_s, d_s, a_s, s_s) = bin_sort(k, o, d, alive, scalar)
    # dead lanes compact to the end
    a_np = np.asarray(a_s)
    first_dead = a_np.argmin() if (~a_np).any() else n
    assert not a_np[first_dead:].any()
    # each sorted row is an original row
    o_u, d_u, a_u, s_u = unsort(sidx, o_s, d_s, a_s, s_s)
    np.testing.assert_array_equal(np.asarray(o_u), np.asarray(o))
    np.testing.assert_array_equal(np.asarray(d_u), np.asarray(d))
    np.testing.assert_array_equal(np.asarray(a_u), np.asarray(alive))
    np.testing.assert_array_equal(np.asarray(s_u), np.asarray(scalar))


def test_bin_sort_custom_vjp_matches_native_sort_grad():
    """bin_sort/unsort carry a custom VJP that moves cotangents with a
    variadic payload sort instead of a scatter transpose. The gradient
    must equal jax's native lax.sort autodiff exactly."""
    rng = np.random.default_rng(7)
    n = 1024
    key_arr = jnp.asarray(rng.integers(0, 257, n), jnp.int32)
    x = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    alive = jnp.asarray(rng.integers(0, 2, n).astype(bool))
    w = jnp.asarray(rng.random((n, 3)).astype(np.float32))

    def loss_custom(x):
        sidx, (xs, a_s) = bin_sort(key_arr, x, alive)
        (back,) = unsort(sidx, xs * xs)
        return jnp.sum(back * w)

    def loss_native(x):
        iota = jnp.arange(n, dtype=jnp.int32)
        out = jax.lax.sort(
            (key_arr, iota) + tuple(x[:, j] for j in range(3)), num_keys=1)
        sidx = out[1]
        xs = jnp.stack(out[2:], axis=1)
        sq = xs * xs
        out2 = jax.lax.sort(
            (sidx,) + tuple(sq[:, j] for j in range(3)), num_keys=1)
        back = jnp.stack(out2[1:], axis=1)
        return jnp.sum(back * w)

    g_custom = jax.jit(jax.grad(loss_custom))(x)
    g_native = jax.jit(jax.grad(loss_native))(x)
    np.testing.assert_allclose(np.asarray(g_custom), np.asarray(g_native),
                               rtol=1e-6, atol=1e-7)


def test_subdivided_teapot_same_surface():
    from raytracing_tpu.accel.packets import build_cluster_accel
    from raytracing_tpu.geometry.mesh import Scene
    from raytracing_tpu.geometry.scene import (
        subdivided_teapot_mesh,
        sun_position,
        teapot_only_mesh,
    )
    from raytracing_tpu.models.whitted import render

    m0 = teapot_only_mesh()
    m1 = subdivided_teapot_mesh(levels=1)
    assert m1.num_triangles == 4 * m0.num_triangles
    cfg = RenderConfig(width=48, height=48, samples_per_pixel=1,
                       backend="cluster", reflect_depth=1, diffuse_depth=0)
    i0 = np.asarray(render(Scene(mesh=m0, sun=sun_position(0.0)), cfg,
                           accel=build_cluster_accel(m0),
                           key=jax.random.PRNGKey(0)))
    i1 = np.asarray(render(Scene(mesh=m1, sun=sun_position(0.0)), cfg,
                           accel=build_cluster_accel(m1),
                           key=jax.random.PRNGKey(0)))
    # Midpoint subdivision reproduces the same flat surface; allow a tiny
    # fraction of edge pixels to differ by epsilon-tier intersections.
    frac_diff = (np.abs(i0 - i1).max(axis=-1) > 1e-3).mean()
    assert frac_diff < 0.01, frac_diff
