"""Tests of nearest-hit/any-hit engines: brute-force oracle properties and
cluster-accel equivalence (the accelerated path must match the oracle
exactly on hit ids and allclose on t)."""

import jax.numpy as jnp
import numpy as np

from raytracing_tpu.accel.packets import (
    any_hit_cluster,
    build_cluster_accel,
    nearest_hit_cluster,
    packed_triangles,
)
from raytracing_tpu.geometry.mesh import triangle_soa
from raytracing_tpu.geometry.scene import build_default_mesh
from raytracing_tpu.ops.trace import any_hit_brute, nearest_hit_brute


def _random_rays(rng, n, origin_box=2.0, aim=(1.0, -1.0, 7.5)):
    o = rng.uniform(-origin_box, origin_box, size=(n, 3)).astype(np.float32)
    o[:, 2] = 0.0
    target = np.asarray(aim) + rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    d = (target - o).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def test_brute_hits_teapot(teapot_mesh):
    tri = triangle_soa(teapot_mesh.verts, teapot_mesh.tri_v)
    o = jnp.zeros((3, 3))
    d = jnp.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]])
    hit = nearest_hit_brute(tri, o, d)
    assert bool(hit.hit[0])  # straight at the teapot (offset (0,0,3))
    assert not bool(hit.hit[1])  # straight up: sky
    assert not bool(hit.hit[2])  # behind
    assert 0.0 < float(hit.t[0]) < 10.0


def test_brute_returns_nearest(rng):
    # Two parallel quads; rays must hit the closer one.
    import jax.numpy as jnp

    from raytracing_tpu.ops.intersect import TriangleSoA

    v0 = jnp.array([[-5.0, -5.0, 2.0], [-5.0, -5.0, 4.0]])
    e1 = jnp.array([[10.0, 0.0, 0.0], [10.0, 0.0, 0.0]])
    e2 = jnp.array([[0.0, 10.0, 0.0], [0.0, 10.0, 0.0]])
    tri = TriangleSoA(v0, e1, e2)
    o = jnp.zeros((4, 3))
    d = jnp.array([[0.0, 0.0, 1.0]] * 4)
    hit = nearest_hit_brute(tri, o, d)
    assert (np.asarray(hit.tri) == 0).all()
    np.testing.assert_allclose(np.asarray(hit.t), 2.0, rtol=1e-6)


def test_cluster_matches_brute_nearest(rng):
    mesh = build_default_mesh()
    accel = build_cluster_accel(mesh, cluster_size=128)
    o, d = _random_rays(rng, 512)
    tri = triangle_soa(mesh.verts, mesh.tri_v)
    hb = nearest_hit_brute(tri, o, d)
    hc = nearest_hit_cluster(mesh, accel, o, d)
    np.testing.assert_array_equal(np.asarray(hb.hit), np.asarray(hc.hit))
    m = np.asarray(hb.hit)
    np.testing.assert_allclose(np.asarray(hb.t)[m], np.asarray(hc.t)[m],
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(hb.tri)[m], np.asarray(hc.tri)[m])


def test_cluster_matches_brute_anyhit(rng):
    mesh = build_default_mesh()
    accel = build_cluster_accel(mesh, cluster_size=128)
    o, d = _random_rays(rng, 512)
    ab = any_hit_brute(triangle_soa(mesh.verts, mesh.tri_v), o, d)
    ac = any_hit_cluster(mesh, accel, o, d)
    np.testing.assert_array_equal(np.asarray(ab), np.asarray(ac))


def test_cluster_index_sort_parity(rng):
    # The reference's locality sort (opt.rs:11-36) as an alternative packing.
    mesh = build_default_mesh()
    accel = build_cluster_accel(mesh, cluster_size=64, method="index")
    o, d = _random_rays(rng, 256)
    hb = nearest_hit_brute(triangle_soa(mesh.verts, mesh.tri_v), o, d)
    hc = nearest_hit_cluster(mesh, accel, o, d)
    m = np.asarray(hb.hit)
    np.testing.assert_array_equal(m, np.asarray(hc.hit))
    np.testing.assert_array_equal(np.asarray(hb.tri)[m], np.asarray(hc.tri)[m])


def test_accel_structure_invariants():
    mesh = build_default_mesh()
    accel = build_cluster_accel(mesh, cluster_size=128)
    order = np.asarray(accel.order)
    valid = np.asarray(accel.slot_valid)
    assert order.shape[0] % 128 == 0
    # Every real triangle appears exactly once — across the clustered
    # slots and the dense rest set (small objects, e.g. the 2-triangle
    # ground plane) together.
    parts = [order[valid]]
    if accel.rest_ids is not None:
        parts.append(np.asarray(accel.rest_ids))
    real = np.sort(np.concatenate(parts))
    np.testing.assert_array_equal(real, np.arange(mesh.num_triangles))
    # Cluster AABBs contain their member triangles' vertices.
    tri = packed_triangles(mesh, accel)
    v0 = np.asarray(tri.v0).reshape(accel.num_clusters, -1, 3)
    ok = valid.reshape(accel.num_clusters, -1)
    cmin = np.asarray(accel.cluster_min)[:, None]
    cmax = np.asarray(accel.cluster_max)[:, None]
    inside = ((v0 >= cmin - 1e-4) & (v0 <= cmax + 1e-4)).all(-1)
    assert (inside | ~ok).all()
    # Padding slots are degenerate.
    e1 = np.asarray(tri.e1)
    assert (np.abs(e1[~valid]) == 0).all()


def test_rest_set_extraction():
    # The ground plane (2 tris, object 2) must land in the rest set, and
    # both engines must still report hits on it with original ids.
    mesh = build_default_mesh()
    accel = build_cluster_accel(mesh, cluster_size=16)
    assert accel.rest_ids is not None
    rest = np.asarray(accel.rest_ids)
    obj = np.asarray(mesh.obj_id)
    assert (obj[rest] == 2).all() and rest.shape[0] == 2
    # A straight-down ray hits only the ground.
    o = jnp.array([[6.0, 5.0, 12.0]])
    d = jnp.array([[0.0, -1.0, 0.0]])
    hc = nearest_hit_cluster(mesh, accel, o, d)
    tri = triangle_soa(mesh.verts, mesh.tri_v)
    hb = nearest_hit_brute(tri, o, d)
    assert bool(hc.hit[0]) and int(hc.tri[0]) == int(hb.tri[0])
    np.testing.assert_allclose(float(hc.t[0]), float(hb.t[0]), rtol=1e-6)
    # Pallas walk (interpret): same hit, same original (rest) triangle id,
    # so shading gathers the ground's attributes.
    from raytracing_tpu.kernels.traverse import nearest_hit_pallas

    h = nearest_hit_pallas(mesh, accel, o, d, interpret=True)
    assert bool(h.hit[0]) and int(h.tri[0]) == int(hb.tri[0])
    assert int(h.tri[0]) in rest
    np.testing.assert_allclose(float(h.t[0]), float(hb.t[0]), rtol=1e-6)


def test_sah_sweep_matches_recursive_quality(teapot_mesh):
    """The level-synchronous SAH sweep (_sah_sweep_order) must be a
    permutation and match the per-node recursive sweep's cluster quality
    (same objective + candidate set; only tie-breaking differs) while
    beating the median split."""
    from raytracing_tpu.accel.packets import (
        _median_split_order,
        _sah_split_order,
        _sah_sweep_order,
    )

    v = np.asarray(teapot_mesh.verts)
    tv = np.asarray(teapot_mesh.tri_v)
    tvv = v[tv]
    cent, blo, bhi = tvv.mean(1), tvv.min(1), tvv.max(1)

    def cluster_sa(order, cs):
        n = len(order)
        nb = (n + cs - 1) // cs
        pad = nb * cs - n
        lo, hi = blo[order], bhi[order]
        if pad:
            lo = np.concatenate([lo, np.full((pad, 3), 1e30, np.float32)])
            hi = np.concatenate([hi, np.full((pad, 3), -1e30, np.float32)])
        clo = lo.reshape(nb, cs, 3).min(1)
        chi = hi.reshape(nb, cs, 3).max(1)
        e = np.maximum(chi - clo, 0)
        return float((e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2]
                      + e[:, 2] * e[:, 0]).sum())

    for cs in (16, 64):
        new = _sah_sweep_order(cent, blo, bhi, cs)
        assert np.array_equal(np.sort(new), np.arange(len(cent)))
        sa_new = cluster_sa(new, cs)
        sa_rec = cluster_sa(_sah_split_order(cent, blo, bhi, cs), cs)
        sa_med = cluster_sa(_median_split_order(cent, cs), cs)
        assert sa_new <= sa_rec * 1.05, (cs, sa_new, sa_rec)
        assert sa_new < sa_med, (cs, sa_new, sa_med)
