"""Native C++ runtime parity tests (skipped when the library isn't built;
CI/driver builds it with `make -C csrc`)."""

import subprocess

import numpy as np
import pytest

from raytracing_tpu.geometry import native
from raytracing_tpu.geometry.obj import read_obj_numpy
from raytracing_tpu.geometry.scene import TEAPOT_OBJ


@pytest.fixture(scope="module", autouse=True)
def build_native():
    if not native.available():
        try:
            subprocess.run(["make", "-C", "csrc"], check=True, cwd="/root/repo",
                           capture_output=True, timeout=120)
        except Exception:
            pass
        native._load_failed = False
        native._lib = None
    if not native.available():
        pytest.skip("native library unavailable")


def test_native_obj_matches_numpy():
    v_n, t_n = native.parse_obj(TEAPOT_OBJ)
    v_p, t_p = read_obj_numpy(TEAPOT_OBJ)
    np.testing.assert_allclose(v_n, v_p, rtol=1e-6)
    np.testing.assert_array_equal(t_n, t_p)


def test_native_obj_extensions(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "f 1/1/1 2/2/2 3/3/3 4/4/4\n"
        "f -4 -3 -2\n"
    )
    v_n, t_n = native.parse_obj(str(p))
    v_p, t_p = read_obj_numpy(str(p))
    np.testing.assert_allclose(v_n, v_p)
    np.testing.assert_array_equal(t_n, t_p)


def test_native_morton_matches_numpy(rng):
    from raytracing_tpu.accel.packets import _morton_codes

    pts = rng.normal(size=(4096, 3)).astype(np.float32)
    order_native = native.morton_order(pts)
    order_np = np.argsort(_morton_codes(pts), kind="stable")
    np.testing.assert_array_equal(order_native, order_np)


def test_native_sah_sweep_matches_numpy(rng, build_native):
    """rt_sah_sweep_order must reproduce the numpy exact-sweep builder
    bit-for-bit (same candidates, f32 rounding, and tie rules) — including
    a tie-heavy structured grid."""
    from raytracing_tpu.accel.packets import _sah_sweep_order

    for n, cs in ((37, 8), (3000, 16), (20000, 64)):
        v0 = rng.normal(size=(n, 3)).astype(np.float32) * 5
        e = rng.random(size=(n, 2, 3)).astype(np.float32)
        tv = np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)
        cent = tv.mean(axis=1)
        blo = tv.min(axis=1)
        bhi = tv.max(axis=1)
        got = native.sah_sweep_order(cent, blo, bhi, cs)
        want = _sah_sweep_order(cent, blo, bhi, cs)
        np.testing.assert_array_equal(got, want)
    g = 24  # axis-aligned grid: every centroid component tied many ways
    gx, gy = np.meshgrid(np.arange(g, dtype=np.float32),
                         np.arange(g, dtype=np.float32))
    v0 = np.stack([gx.ravel(), gy.ravel(), np.zeros(g * g, np.float32)], 1)
    tv = np.stack([v0, v0 + [1, 0, 0], v0 + [0, 1, 0]], 1).astype(np.float32)
    got = native.sah_sweep_order(tv.mean(1), tv.min(1), tv.max(1), 16)
    want = _sah_sweep_order(tv.mean(1), tv.min(1), tv.max(1), 16)
    np.testing.assert_array_equal(got, want)


def test_native_subdivide_matches_numpy(rng, build_native):
    """rt_subdivide_level must reproduce subdivide_arrays exactly
    (np.unique edge-key order defines the new vertex numbering)."""
    from raytracing_tpu.geometry.subdivide import subdivide_arrays

    verts = rng.normal(size=(60, 3)).astype(np.float32)
    tris = rng.integers(0, 60, size=(90, 3)).astype(np.int32)
    old = native.available
    native.available = lambda: False
    try:
        v_np, t_np = subdivide_arrays(verts, tris, levels=2)
    finally:
        native.available = old
    v_nat, t_nat = subdivide_arrays(verts, tris, levels=2)
    np.testing.assert_array_equal(v_nat, v_np)
    np.testing.assert_array_equal(t_nat, t_np)
