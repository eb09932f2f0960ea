"""Headline benchmark: primary rays/s on the teapot scene, on a GPU.

Times the nearest-hit query (`tracer.nearest_hit` with the backend "auto"
resolves to: the Pallas walk on a GPU) over the reference workload's
primary rays — 800x800 with 4 stratified samples = 2.56M rays per frame
(/root/reference/src/main.rs:29-36, :321-365) in pixel-block order —
against the default two-teapots-and-ground scene (12,642 triangles).

Each timed call ends in block_until_ready; the first call (compilation)
is reported apart. A hit-fraction gate refuses to report if the query
traced nothing. Without a GPU the benchmark exits non-zero: a CPU number
is not a measurement of this system.

Prints ONE JSON line: {"metric", "value", "unit", "platform",
"device_kind", "device_count", ...}.
"""

import json
import sys
import time

import jax
import numpy as np

from raytracing_tpu.utils.cache import enable_persistent_cache


def measure(reps: int = 20) -> dict:
    """Run the headline measurement and return its record."""
    from raytracing_tpu.accel.packets import build_cluster_accel
    from raytracing_tpu.config import RenderConfig
    from raytracing_tpu.geometry.scene import build_default_scene
    from raytracing_tpu.models.camera import block_ray_ids, camera_rays_for_ids
    from raytracing_tpu.tracer import nearest_hit, resolve_backend

    dev = jax.devices()
    if dev[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's default device is "
                         f"{dev[0].platform!r}")
    cfg = RenderConfig(backend="auto")
    scene = build_default_scene(t=0.0)
    accel = build_cluster_accel(scene.mesh)
    r = cfg.width * cfg.height * cfg.samples_per_pixel
    o, d = jax.jit(lambda i: camera_rays_for_ids(i, cfg))(
        block_ray_ids(0, r, cfg))
    query = jax.jit(lambda o_, d_: nearest_hit(scene.mesh, accel, o_, d_,
                                               cfg))
    t0 = time.perf_counter()
    hit = jax.block_until_ready(query(o, d))
    first = time.perf_counter() - t0
    hit_frac = float(np.asarray(hit.hit).mean())
    if not 0.2 < hit_frac < 0.9:
        raise SystemExit(f"implausible hit fraction {hit_frac:.3f}")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(query(o, d))
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {
        "metric": "primary_rays_per_s_teapot",
        "value": r / best,
        "unit": "rays/s",
        "seconds_best": best,
        "seconds_median": float(np.median(times)),
        "first_call_seconds": first,
        "hit_fraction": hit_frac,
        "backend": resolve_backend(cfg.backend),
        "platform": dev[0].platform,
        "device_kind": dev[0].device_kind,
        "device_count": len(dev),
    }


def main() -> None:
    enable_persistent_cache()
    print(json.dumps(measure()))


if __name__ == "__main__":
    sys.exit(main())
