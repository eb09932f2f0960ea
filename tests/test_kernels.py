"""Walk-kernel tests. Here (no GPU) the kernel runs in the Pallas
interpreter with an explicit interpret=True; these pin down its semantics
against the bruteforce oracle. Its compiled form is checked by lowering it
for CUDA (the Triton IR), and on the card by the tests marked `gpu` and by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytracing_tpu.kernels.traverse as T
from raytracing_tpu.accel.packets import build_cluster_accel
from raytracing_tpu.geometry.mesh import triangle_soa
from raytracing_tpu.geometry.scene import build_default_scene, teapot_only_mesh
from raytracing_tpu.kernels.traverse import any_hit_pallas, nearest_hit_pallas
from raytracing_tpu.ops.trace import any_hit_brute, nearest_hit_brute


@pytest.fixture(scope="module")
def setup(rng):
    mesh = teapot_only_mesh()
    accel = build_cluster_accel(mesh, cluster_size=128)
    n = 128
    o = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    o[:, 2] = 0.0
    tgt = np.array([0.0, 0.0, 3.0]) + rng.normal(size=(n, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    return mesh, accel, jnp.asarray(o), jnp.asarray(d)


@pytest.fixture(scope="module")
def scene_rays():
    """The default scene (two teapots + the rest-set ground plane) and a
    ray batch mixing teapot hits, ground hits and sky misses."""
    scene = build_default_scene(t=0.0)
    rng = np.random.default_rng(11)
    n = 200
    o = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    o[:, 2] = 0.0
    tgt = np.concatenate([
        np.array([-0.9, -2.0, 9.0]) + rng.normal(size=(n // 2, 3)) * 2.0,
        np.array([0.0, -3.0, 40.0]) + rng.normal(size=(n // 4, 3)) * 10.0,
        np.array([0.0, 40.0, 10.0]) + rng.normal(size=(n - n // 2 - n // 4,
                                                        3)) * 5.0,
    ]).astype(np.float32)
    return scene, jnp.asarray(o), jnp.asarray(tgt - o)


def _assert_nearest_matches(hb, hp):
    m = np.asarray(hb.hit)
    np.testing.assert_array_equal(m, np.asarray(hp.hit))
    np.testing.assert_array_equal(np.asarray(hb.tri)[m], np.asarray(hp.tri)[m])
    np.testing.assert_allclose(np.asarray(hb.t)[m], np.asarray(hp.t)[m],
                               rtol=1e-5)


def test_pallas_nearest_matches_oracle(setup):
    mesh, accel, o, d = setup
    hb = nearest_hit_brute(triangle_soa(mesh.verts, mesh.tri_v), o, d)
    hp = nearest_hit_pallas(mesh, accel, o, d, interpret=True)
    _assert_nearest_matches(hb, hp)


def test_pallas_anyhit_matches_oracle(setup):
    mesh, accel, o, d = setup
    ab = any_hit_brute(triangle_soa(mesh.verts, mesh.tri_v), o, d)
    ap = any_hit_pallas(mesh, accel, o, d, interpret=True)
    np.testing.assert_array_equal(np.asarray(ab), np.asarray(ap))


def test_accel_kernel_blocks_layout(setup):
    mesh, accel, _, _ = setup
    c, rows, cs = accel.tri_blocks.shape
    assert rows == 9 and cs == accel.cluster_size and c == accel.num_clusters
    # Row layout: v0(3) e1(3) e2(3) per cluster, triangles on the last axis.
    from raytracing_tpu.accel.packets import packed_triangles

    tri = packed_triangles(mesh, accel)
    blocks = np.asarray(accel.tri_blocks).transpose(0, 2, 1).reshape(-1, 9)
    np.testing.assert_array_equal(blocks[:, 0:3], np.asarray(tri.v0))
    np.testing.assert_array_equal(blocks[:, 3:6], np.asarray(tri.e1))
    np.testing.assert_array_equal(blocks[:, 6:9], np.asarray(tri.e2))


def test_pallas_grad_through_lazy_t(setup):
    """Vertex gradients flow through the kernel's lazy-refined t."""
    mesh, accel, o, d = setup

    def loss(verts):
        m = mesh._replace(verts=verts)
        h = nearest_hit_pallas(m, accel, o[:32], d[:32], interpret=True)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    g = np.asarray(jax.grad(loss)(mesh.verts))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0


def test_visit_list_overflow_fallback(setup, rng, monkeypatch):
    """Blocks whose true cluster count exceeds the static visit-list width
    must fall back to scanning all clusters — incoherent ray batches hit
    this (the frustum of a random-direction block covers the whole
    scene)."""
    mesh, accel, _, _ = setup
    monkeypatch.setattr(T, "MAX_VISITS", 2)  # force overflow on any block
    n = 64
    o = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)  # fully incoherent
    hb = nearest_hit_brute(triangle_soa(mesh.verts, mesh.tri_v),
                           jnp.asarray(o), jnp.asarray(d))
    hp = nearest_hit_pallas(mesh, accel, jnp.asarray(o), jnp.asarray(d),
                            interpret=True)
    np.testing.assert_array_equal(np.asarray(hb.hit), np.asarray(hp.hit))
    m = np.asarray(hb.hit)
    np.testing.assert_array_equal(np.asarray(hb.tri)[m], np.asarray(hp.tri)[m])


def test_visit_list_overflow_anyhit(setup, rng, monkeypatch):
    mesh, accel, _, _ = setup
    monkeypatch.setattr(T, "MAX_VISITS", 2)
    n = 64
    o = jnp.asarray(rng.uniform(-1, 1, size=(n, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    ab = any_hit_brute(triangle_soa(mesh.verts, mesh.tri_v), o, d)
    ap = any_hit_pallas(mesh, accel, o, d, interpret=True)
    np.testing.assert_array_equal(np.asarray(ab), np.asarray(ap))
    assert np.asarray(ab).any()


def test_pallas_large_scene_early_exit_matches_oracle(rng):
    """A finely tessellated scene (101k triangles, >6k clusters of 16):
    long front-to-back visit lists and the per-visit best-t skip must still
    reproduce the oracle exactly."""
    from raytracing_tpu.geometry.scene import subdivided_teapot_mesh

    mesh = subdivided_teapot_mesh(levels=2)  # 101k tris
    accel = build_cluster_accel(mesh, cluster_size=16)
    assert accel.num_clusters > T.MAX_VISITS
    n = 64
    o = jnp.zeros((n, 3))
    tgt = np.array([0.0, 0.0, 3.0]) + rng.normal(size=(n, 3)) * 1.2
    d = jnp.asarray(tgt.astype(np.float32))
    hp = nearest_hit_pallas(mesh, accel, o, d, interpret=True)
    hb = nearest_hit_brute(triangle_soa(mesh.verts, mesh.tri_v), o, d)
    m = np.asarray(hb.hit)
    assert m.any() and not m.all()
    _assert_nearest_matches(hb, hp)


@pytest.mark.parametrize("mode", ["nearest", "nearest_attrs", "anyhit",
                                  "anyhit_tmax"])
@pytest.mark.parametrize("cs", [8, 16, 32])
def test_walk_matches_oracle(scene_rays, cs, mode):
    """Walk vs the bruteforce oracle over the default scene (rest set
    included), per cluster size and query kind: nearest hit, nearest hit
    plus the shading attributes gathered by its triangle id, occlusion,
    and occlusion with a per-ray t_max row."""
    scene, o, d = scene_rays
    mesh = scene.mesh
    accel = build_cluster_accel(mesh, cluster_size=cs)
    tri = triangle_soa(mesh.verts, mesh.tri_v)
    if mode.startswith("nearest"):
        hb = nearest_hit_brute(tri, o, d)
        hp = nearest_hit_pallas(mesh, accel, o, d, interpret=True)
        assert 0.2 < np.asarray(hb.hit).mean() < 0.95
        _assert_nearest_matches(hb, hp)
        if mode == "nearest_attrs":
            from raytracing_tpu.models.whitted import _attribute_rows

            rows = np.asarray(_attribute_rows(mesh))
            m = np.asarray(hb.hit)
            np.testing.assert_array_equal(rows[np.asarray(hp.tri)[m]],
                                          rows[np.asarray(hb.tri)[m]])
        return
    t_max = jnp.inf
    if mode == "anyhit_tmax":
        t_max = jnp.asarray(np.linspace(0.5, 40.0, o.shape[0])
                            .astype(np.float32))
    ab = any_hit_brute(tri, o, d, t_max)
    ap = any_hit_pallas(mesh, accel, o, d, t_max=t_max, interpret=True)
    assert 0.1 < np.asarray(ab).mean() < 0.95
    np.testing.assert_array_equal(np.asarray(ab), np.asarray(ap))


@pytest.mark.parametrize("n", [1, 127, 129, 300])
def test_walk_ray_count_not_multiple_of_block(scene_rays, n):
    """Ray counts that do not fill the last walk block are padded with
    dead rays; the outputs keep the caller's length and agree with the
    oracle."""
    scene, o, d = scene_rays
    reps = -(-n // o.shape[0])
    o = jnp.tile(o, (reps, 1))[:n]
    d = jnp.tile(d, (reps, 1))[:n]
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    tri = triangle_soa(scene.mesh.verts, scene.mesh.tri_v)
    hp = nearest_hit_pallas(scene.mesh, accel, o, d, interpret=True)
    assert hp.t.shape == (n,) and hp.tri.shape == (n,)
    _assert_nearest_matches(nearest_hit_brute(tri, o, d), hp)
    ap = any_hit_pallas(scene.mesh, accel, o, d, interpret=True)
    assert ap.shape == (n,)
    np.testing.assert_array_equal(np.asarray(any_hit_brute(tri, o, d)),
                                  np.asarray(ap))


@pytest.mark.parametrize("nearest", [True, False])
def test_walk_dead_lanes(scene_rays, nearest):
    """Dead lanes may carry garbage (NaN) rays: they are left out of the
    block frustums, and the alive lanes still match the oracle."""
    scene, o, d = scene_rays
    n = o.shape[0]
    alive = np.arange(n) % 3 != 0
    o_g = jnp.where(alive[:, None], o, jnp.nan)
    d_g = jnp.where(alive[:, None], d, jnp.nan)
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    # Culling sees only alive lanes: garbage in the dead ones changes
    # no visit list.
    lists = [T.visit_lists(T._pad_rays(T.rays_to_soa(oo, dd,
                                                     jnp.asarray(alive)),
                                       T.RAY_BLOCK),
                           accel.cluster_min, accel.cluster_max)
             for oo, dd in ((o_g, d_g), (o, d))]
    np.testing.assert_array_equal(np.asarray(lists[0][1]),
                                  np.asarray(lists[1][1]))
    np.testing.assert_array_equal(np.asarray(lists[0][0]),
                                  np.asarray(lists[1][0]))
    tri = triangle_soa(scene.mesh.verts, scene.mesh.tri_v)
    if nearest:
        hp = nearest_hit_pallas(scene.mesh, accel, o_g, d_g,
                                alive=jnp.asarray(alive), interpret=True)
        hb = nearest_hit_brute(tri, o, d)
        m = np.asarray(hb.hit) & alive
        np.testing.assert_array_equal(np.asarray(hp.hit)[alive],
                                      np.asarray(hb.hit)[alive])
        np.testing.assert_array_equal(np.asarray(hp.tri)[m],
                                      np.asarray(hb.tri)[m])
    else:
        ap = any_hit_pallas(scene.mesh, accel, o_g, d_g,
                            alive=jnp.asarray(alive), interpret=True)
        ab = any_hit_brute(tri, o, d)
        np.testing.assert_array_equal(np.asarray(ap)[alive],
                                      np.asarray(ab)[alive])


def test_all_dead_blocks_visit_nothing(scene_rays):
    scene, o, d = scene_rays
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    rays8 = T._pad_rays(T.rays_to_soa(o, d, jnp.zeros(o.shape[0], bool)),
                        T.RAY_BLOCK)
    _, cnt = T.visit_lists(rays8, accel.cluster_min, accel.cluster_max)
    assert int(cnt.max()) == 0


def test_visit_lists_hold_every_hit_cluster(scene_rays):
    """Culling is conservative: the cluster holding each ray's oracle hit
    is in its block's visit list (or the block overflows to a full
    scan)."""
    scene, o, d = scene_rays
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    rays8 = T._pad_rays(T.rays_to_soa(o, d), T.RAY_BLOCK)
    ids, cnt = T.visit_lists(rays8, accel.cluster_min, accel.cluster_max)
    ids, cnt = np.asarray(ids), np.asarray(cnt)
    hb = nearest_hit_brute(triangle_soa(scene.mesh.verts, scene.mesh.tri_v),
                           o, d)
    slot_of = {int(t): s for s, t in enumerate(np.asarray(accel.order))
               if np.asarray(accel.slot_valid)[s]}
    checked = 0
    for r in np.nonzero(np.asarray(hb.hit))[0]:
        tri_id = int(np.asarray(hb.tri)[r])
        if tri_id not in slot_of:
            continue  # rest-set triangle: merged outside the walk
        b = r // T.RAY_BLOCK
        cluster = slot_of[tri_id] // accel.cluster_size
        w = ids.shape[1]
        assert cnt[b] > w or cluster in ids[b, :cnt[b]]
        checked += 1
    assert checked > 20


@pytest.mark.parametrize("wrt", ["verts", "origins", "directions"])
def test_grad_rule_matches_bruteforce(setup, wrt):
    """The lazy-t VJP (forward = kernel t, backward = live-vertex
    Möller–Trumbore) gives the bruteforce backend's gradients."""
    mesh, accel, o, d = setup
    o, d = o[:48], d[:48]
    tri_of = lambda m: triangle_soa(m.verts, m.tri_v)  # noqa: E731

    def loss(fn):
        def f(verts, o_, d_):
            m = mesh._replace(verts=verts)
            h = fn(m, o_, d_)
            return jnp.sum(jnp.where(h.hit, h.t, 0.0) ** 2)
        return f

    argnum = {"verts": 0, "origins": 1, "directions": 2}[wrt]
    gp = jax.grad(loss(lambda m, o_, d_: nearest_hit_pallas(
        m, accel, o_, d_, interpret=True)), argnums=argnum)(mesh.verts, o, d)
    gb = jax.grad(loss(lambda m, o_, d_: nearest_hit_brute(
        tri_of(m), o_, d_)), argnums=argnum)(mesh.verts, o, d)
    assert np.abs(np.asarray(gb)).max() > 0
    # Same f32 expression for the winning triangle on both sides; the
    # bruteforce scan's fused vector form rounds differently (the
    # renderer-level test_grad_pallas_backend_matches_brute bound).
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gb), rtol=2e-4,
                               atol=1e-6)


def test_resolve_backend_auto():
    from raytracing_tpu.tracer import resolve_backend

    # CPU test environment: auto must resolve to the XLA cluster backend.
    assert resolve_backend("auto") == "cluster"
    for b in ("bruteforce", "cluster", "pallas"):
        assert resolve_backend(b) == b


def test_resolve_backend_auto_on_gpu(monkeypatch):
    from raytracing_tpu import tracer

    monkeypatch.setattr(tracer.jax, "default_backend", lambda: "gpu")
    assert tracer.resolve_backend("auto") == "pallas"


def test_resolve_backend_rejects_unknown():
    from raytracing_tpu.tracer import resolve_backend

    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("megakernel")


@pytest.mark.parametrize("query", ["nearest", "anyhit"])
def test_pallas_without_gpu_raises(setup, query):
    """Without a GPU the kernel never falls back silently: asking for it
    without interpret=True is an error."""
    mesh, accel, o, d = setup
    fn = nearest_hit_pallas if query == "nearest" else any_hit_pallas
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        fn(mesh, accel, o, d)


def test_render_pallas_without_gpu_raises(default_scene):
    from raytracing_tpu.config import RenderConfig
    from raytracing_tpu.models.whitted import render

    accel = build_cluster_accel(default_scene.mesh, cluster_size=16)
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       backend="pallas", chunk_size=256)
    with pytest.raises(RuntimeError, match="interpret=True"):
        render(default_scene, cfg, accel=accel)


def test_rays_to_soa_layout():
    o = jnp.arange(6, dtype=jnp.float32).reshape(2, 3)
    d = -o
    p = np.asarray(T.rays_to_soa(o, d, jnp.array([True, False]),
                                 jnp.array([2.0, 5.0])))
    np.testing.assert_array_equal(p[0:3], np.asarray(o).T)
    np.testing.assert_array_equal(p[3], [1.0, 0.0])
    np.testing.assert_array_equal(p[4:7], np.asarray(d).T)
    np.testing.assert_array_equal(p[7], [2.0, 5.0])
    p = np.asarray(T._pad_rays(T.rays_to_soa(o, d), 8))
    assert p.shape == (8, 8) and (p[3, 2:] == 0).all()  # dead padding


@pytest.mark.parametrize("nearest", [True, False])
def test_walk_kernel_lowers_for_cuda(setup, nearest, monkeypatch):
    """The kernel lowers to Triton IR for a CUDA device (no card needed):
    catches primitives the Triton route cannot express, which the
    interpreter would accept."""
    _, accel, o, d = setup
    monkeypatch.setattr(T, "_require_gpu", lambda interpret: None)
    f = jax.jit(lambda r: T._walk(accel, r, 1e-8, nearest, interpret=False))
    text = f.trace(T.rays_to_soa(o, d)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "custom_call @__gpu$xla.gpu.triton" in text


@pytest.mark.gpu
@pytest.mark.parametrize("cs", [16, 32])
def test_walk_compiled_matches_oracle_on_gpu(gpu, cs):
    """The compiled kernel (no interpreter) against the oracle."""
    scene = build_default_scene(t=0.0)
    rng = np.random.default_rng(5)
    n = 4096
    o = jnp.zeros((n, 3))
    d = jnp.asarray(np.concatenate(
        [rng.uniform(-1, 1, (n, 2)), np.ones((n, 1))], 1).astype(np.float32))
    accel = build_cluster_accel(scene.mesh, cluster_size=cs)
    tri = triangle_soa(scene.mesh.verts, scene.mesh.tri_v)
    hb = nearest_hit_brute(tri, o, d)
    hp = nearest_hit_pallas(scene.mesh, accel, o, d)
    m = np.asarray(hb.hit)
    agree = (m == np.asarray(hp.hit)) & (
        ~m | (np.asarray(hb.tri) == np.asarray(hp.tri)))
    assert agree.mean() >= 0.9999
    np.testing.assert_array_equal(np.asarray(any_hit_brute(tri, o, d)),
                                  np.asarray(any_hit_pallas(scene.mesh,
                                                            accel, o, d)))
