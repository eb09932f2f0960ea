"""ctypes bindings to the native C++ host runtime (csrc/raytracing_native.cpp).

The reference's host-side hot paths are native Rust (OBJ parse, locality
sort, packet build — src/main.rs:38-72, src/opt.rs). Ours are native C++,
loaded lazily; every entry point has a numpy fallback so the framework works
without the toolchain. Build with `make -C csrc` (see csrc/Makefile).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc",
    "libraytracing_native.so",
)
_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.rt_parse_obj_count.restype = ctypes.c_int
        lib.rt_parse_obj_count.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.rt_parse_obj_fill.restype = ctypes.c_int
        lib.rt_parse_obj_fill.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_long,
        ]
        lib.rt_morton_order.restype = ctypes.c_int
        lib.rt_morton_order.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # centroids [T,3]
            ctypes.c_long,  # T
            ctypes.POINTER(ctypes.c_int),  # out order [T]
        ]
        lib.rt_sah_sweep_order.restype = ctypes.c_int
        lib.rt_sah_sweep_order.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # centroids [T,3]
            ctypes.POINTER(ctypes.c_float),  # blo [T,3]
            ctypes.POINTER(ctypes.c_float),  # bhi [T,3]
            ctypes.c_long,  # T
            ctypes.c_long,  # cluster size
            ctypes.POINTER(ctypes.c_longlong),  # out order [T]
        ]
        lib.rt_subdivide_level.restype = ctypes.c_int
        lib.rt_subdivide_level.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # verts [V,3]
            ctypes.c_long,  # V
            ctypes.POINTER(ctypes.c_int),  # tris [T,3]
            ctypes.c_long,  # T
            ctypes.POINTER(ctypes.c_float),  # out verts [V+3T,3] cap
            ctypes.POINTER(ctypes.c_int),  # out tris [4T,3]
            ctypes.POINTER(ctypes.c_longlong),  # out V'
        ]
        _lib = lib
    except OSError:
        _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def parse_obj(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    nv = ctypes.c_long(0)
    nt = ctypes.c_long(0)
    if lib.rt_parse_obj_count(path.encode(), ctypes.byref(nv), ctypes.byref(nt)) != 0:
        return None
    verts = np.empty((nv.value, 3), dtype=np.float32)
    tris = np.empty((nt.value, 3), dtype=np.int32)
    rc = lib.rt_parse_obj_fill(
        path.encode(),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nv.value,
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        nt.value,
    )
    if rc != 0:
        return None
    return verts, tris


def morton_order(centroids: np.ndarray) -> Optional[np.ndarray]:
    """Spatial (Morton/Z-curve) sort order of triangle centroids [T,3]."""
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, dtype=np.float32)
    out = np.empty(c.shape[0], dtype=np.int32)
    rc = lib.rt_morton_order(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        c.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out if rc == 0 else None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def sah_sweep_order(cent: np.ndarray, blo: np.ndarray, bhi: np.ndarray,
                    cs: int) -> Optional[np.ndarray]:
    """Exact-sweep SAH cluster order — identical output to the numpy
    builder accel/packets._sah_sweep_order (same candidates, f32 rounding
    and tie rules; parity-tested), ~15x faster at 1M+ triangles."""
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(cent, dtype=np.float32)
    lo = np.ascontiguousarray(blo, dtype=np.float32)
    hi = np.ascontiguousarray(bhi, dtype=np.float32)
    out = np.empty(c.shape[0], dtype=np.int64)
    rc = lib.rt_sah_sweep_order(
        _f32p(c), _f32p(lo), _f32p(hi), c.shape[0], int(cs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    return out if rc == 0 else None


def subdivide_level(verts: np.ndarray, tri_v: np.ndarray
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One midpoint (1:4) subdivision level — identical output to
    geometry/subdivide.subdivide_arrays(levels=1)."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, dtype=np.float32)
    t = np.ascontiguousarray(tri_v, dtype=np.int32)
    nv, nt = v.shape[0], t.shape[0]
    out_v = np.empty((nv + 3 * nt, 3), dtype=np.float32)
    out_t = np.empty((4 * nt, 3), dtype=np.int32)
    new_nv = ctypes.c_longlong(0)
    rc = lib.rt_subdivide_level(
        _f32p(v), nv, t.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nt,
        _f32p(out_v), out_t.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ctypes.byref(new_nv),
    )
    if rc != 0:
        return None
    return out_v[: new_nv.value].copy(), out_t
