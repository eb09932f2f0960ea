"""Extended benchmark suite on a GPU — one JSON line per metric.

  backward_over_forward[_arealight]  value_and_grad of a pixel loss w.r.t.
                                     verts/colors/materials vs the forward
                                     render of the same rays (default
                                     scene, then with an area light)
  whitted_frame_seconds[_1600]       full 800x800x4spp reference frame
                                     (reflect 4, 10-ray diffuse, shadows),
                                     then 1600x1600x4spp
  path_tracer_config3_seconds        800x800, 64 spp, 4 bounces
  accel_build_*, rays_per_s_*        structure build and primary
                                     nearest-hit throughput on the
                                     subdivided teapot (404k / 1.6M tris)
  scaling_efficiency_n<N>            per-device rays/s at N devices vs 1
                                     (with more than one device)

Every record carries the device it ran on (platform, device_kind,
device_count). Without a GPU the suite exits non-zero. Every timed call
ends in block_until_ready; first calls (compilation) are left out.

Usage: python bench_suite.py [--skip-frame] [--skip-large] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp

from raytracing_tpu.accel.packets import build_cluster_accel
from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.scene import build_default_scene
from raytracing_tpu.models.camera import block_ray_ids, camera_rays_for_ids
from raytracing_tpu.models.whitted import render, render_rays
from raytracing_tpu.utils.cache import enable_persistent_cache

RECORDS = []


def _emit(metric, value, unit):
    dev = jax.devices()
    rec = {"metric": metric, "value": value, "unit": unit,
           "platform": dev[0].platform, "device_kind": dev[0].device_kind,
           "device_count": len(dev)}
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def _best_of(fn, iters=3):
    """Seconds of the fastest of `iters` calls of fn() after one warm-up
    call (compilation)."""
    jax.block_until_ready(fn(0))
    best = float("inf")
    for k in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(k + 1))
        best = min(best, time.perf_counter() - t0)
    return best


def bench_backward_over_forward(scene, accel, cfg, lights=None):
    """Forward render vs value_and_grad of a scalar pixel loss w.r.t.
    verts + colors + materials on identical 262k-ray batches (16 chunks of
    16Ki rays from the middle of the frame). `lights`: optional
    SphereLight set — soft-shadow queries and their VJP in the loop."""
    ids = jnp.concatenate(
        [block_ray_ids(i, 16384, cfg, 16, 16) for i in range(90, 106)])
    o, d = camera_rays_for_ids(ids, cfg)

    def loss_of(verts, colors, materials, key):
        mesh = scene.mesh._replace(verts=verts, colors=colors,
                                   materials=materials)
        rgb = render_rays(mesh, accel, scene.sun, o, d, key, cfg,
                          lights=lights)
        return jnp.sum(rgb * rgb)

    args = (scene.mesh.verts, scene.mesh.colors, scene.mesh.materials)
    fwd = jax.jit(loss_of)
    bwd = jax.jit(jax.value_and_grad(loss_of, argnums=(0, 1, 2)))
    tf = _best_of(lambda k: fwd(*args, jax.random.PRNGKey(k)))
    tb = _best_of(lambda k: bwd(*args, jax.random.PRNGKey(k)))
    return tb / tf, tf, tb


def bench_large_scene(cfg):
    """Structure build and primary nearest-hit rays/s on the subdivided
    teapot (404k / 1.6M triangles) through the tracer's nearest_hit."""
    from raytracing_tpu.geometry.scene import subdivided_teapot_mesh
    from raytracing_tpu.tracer import nearest_hit

    r = cfg.width * cfg.height * cfg.samples_per_pixel
    o, d = camera_rays_for_ids(block_ray_ids(0, r, cfg), cfg)
    for levels, tag in ((3, "404k"), (4, "1m6")):
        mesh = subdivided_teapot_mesh(levels=levels)
        t0 = time.perf_counter()
        accel = build_cluster_accel(mesh)
        jax.block_until_ready(accel)
        _emit(f"accel_build_{tag}", time.perf_counter() - t0, "s")
        query = jax.jit(lambda o_, d_, a=accel, m=mesh: nearest_hit(
            m, a, o_, d_, cfg).t)
        best = _best_of(lambda k: query(o, d + k * 1e-12))
        _emit(f"rays_per_s_{tag}", r / best, "rays/s")


def bench_path_tracer(scene, accel, cfg):
    """800x800, 64 spp, 4 bounces."""
    from raytracing_tpu.models.path_tracer import (
        PathTracerConfig,
        render as pt_render,
    )

    pt = PathTracerConfig(max_bounces=4, samples_per_pixel=64)
    c = cfg.replace(chunk_size=131072)
    dt = _best_of(lambda k: pt_render(scene, c, pt, accel=accel,
                                      key=jax.random.PRNGKey(k)), iters=1)
    _emit("path_tracer_config3_seconds", dt, "s")
    _emit("path_tracer_config3_paths_per_s", 800 * 800 * 64 / dt, "paths/s")


def bench_frame(scene, cfg, accel):
    """The reference frame at 800x800x4spp, then at 1600x1600x4spp (4x
    the rays: chunk scaling)."""
    dt = _best_of(lambda k: render(scene, cfg, accel=accel,
                                   key=jax.random.PRNGKey(k)), iters=2)
    _emit("whitted_frame_seconds", dt, "s")
    _emit("whitted_fps", 1.0 / dt, "fps")
    big = cfg.replace(width=1600, height=1600)
    dt_h = _best_of(lambda k: render(scene, big, accel=accel,
                                     key=jax.random.PRNGKey(k)), iters=2)
    _emit("whitted_frame_1600_seconds", dt_h, "s")
    _emit("whitted_frame_1600_rays_per_s", 1600 * 1600 * 4 / dt_h, "rays/s")


def bench_scaling(scene, cfg, accel):
    """Per-device rays/s of render_sharded at 1 vs all devices."""
    from raytracing_tpu.parallel.shard import make_device_mesh, render_sharded

    n_all = len(jax.devices())
    sc = cfg.replace(width=512, height=512)
    rate = {}
    for n in (1, n_all):
        dmesh = make_device_mesh(n)
        dt = _best_of(lambda k: render_sharded(
            scene, sc, dmesh, accel=accel, key=jax.random.PRNGKey(k)))
        rate[n] = 512 * 512 * 4 / dt / n
    _emit(f"scaling_efficiency_n{n_all}", rate[n_all] / rate[1], "x")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-frame", action="store_true")
    ap.add_argument("--skip-large", action="store_true")
    ap.add_argument("--out", default=None,
                    help="also write the records to this JSON file")
    args = ap.parse_args()
    enable_persistent_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_suite.py needs a GPU; JAX's default device "
                         f"is {jax.devices()[0].platform!r}")
    scene = build_default_scene(t=0.0)
    cfg = RenderConfig(backend="auto")
    accel = build_cluster_accel(scene.mesh)

    ratio, tf, tb = bench_backward_over_forward(scene, accel, cfg)
    _emit("backward_over_forward", ratio, "x")
    _emit("forward_262k_rays", tf * 1e3, "ms")
    _emit("backward_262k_rays", tb * 1e3, "ms")
    from raytracing_tpu.geometry.mesh import SphereLight

    lights = SphereLight(center=jnp.array([[1.0, 8.0, 7.0]]),
                         radius=jnp.array([1.5]),
                         emission=jnp.array([[1.5, 1.5, 1.5]]))
    ratio_l, tf_l, tb_l = bench_backward_over_forward(
        scene, accel, cfg, lights=lights)
    _emit("backward_over_forward_arealight", ratio_l, "x")
    _emit("forward_262k_rays_arealight", tf_l * 1e3, "ms")
    _emit("backward_262k_rays_arealight", tb_l * 1e3, "ms")

    if not args.skip_frame:
        bench_frame(scene, cfg, accel)
        bench_path_tracer(scene, accel, cfg)

    t0 = time.perf_counter()
    jax.block_until_ready(build_cluster_accel(scene.mesh))
    _emit("accel_build_teapot_scene", (time.perf_counter() - t0) * 1e3, "ms")

    if not args.skip_large:
        bench_large_scene(cfg)
    if len(jax.devices()) > 1:
        bench_scaling(scene, cfg, accel)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(RECORDS, f, indent=1)


if __name__ == "__main__":
    main()
