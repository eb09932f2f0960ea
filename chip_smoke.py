"""Smoke run of the renderer on one CUDA GPU (or four, with --four-cards).

Drives the main path once, at the reference workload, through the entry
points a user calls, and checks every result against the repository's own
oracles:

  1. device      the default JAX device is a GPU; prints its kind and
                 count and the card's name and power limit (nvidia-smi).
  2. walk        the Pallas walk kernel, compiled for the card, against
                 the bruteforce oracle: the reference frame's 2.56M
                 primary rays (nearest hit) and its sun-shadow rays
                 (occlusion), then 65,536 rays into the 1.6M-triangle
                 subdivided teapot (a structure larger than the L2 cache).
  3. frame       `render` with backend "auto" at 800x800x4spp on the
                 default config against a `cluster` render of the same
                 frame, plus a 128x128 render against `bruteforce`; prints
                 the time per frame of both backends.
  4. fit         3 inverse-rendering steps (`models.inverse.fit`) on
                 vertices and colours at 256x256; vertex and colour
                 gradients of the walk against the bruteforce backend's.
  5. memory      compiled.memory_analysis() of the frame's chunk program
                 and the device's peak bytes in use.
  + gpu tests    the tests marked `gpu` in tests/, run in this process.

With --four-cards only the multi-card phase runs: `render_sharded` over a
4-GPU mesh against the 1-card `render` of the same frame, and one
`make_train_step` step on 4 cards against 1 card.

Tolerances (why each holds on the card): the walk computes Möller–Trumbore
in the oracle's operation order, but the card may contract multiplies and
adds into FMAs differently in the two programs, so a ray grazing a
triangle edge can flip: hit masks and triangle ids must agree on >= 99.99%
of rays, and where ids agree |dt| <= 1e-5 t. Images of two backends share
every RNG draw and differ only by such flips: mean |d| <= 1e-4 and at most
0.1% of pixels off by more than 1/255. Gradients: relative L2 error <= 1e-3
(same flips, through the loss).

Run from the root of a checkout: python3 chip_smoke.py [--four-cards].
The last line of standard output is one JSON object; the exit code is
non-zero if any check fails or no GPU is found.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NEAREST_AGREE = 0.9999
T_REL = 1e-5
IMG_MEAN = 1e-4
IMG_FRAC = 1e-3
GRAD_REL = 1e-3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok: {what}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def image_agreement(a, b, label):
    diff = np.abs(np.asarray(a) - np.asarray(b))
    mean = float(diff.mean())
    frac = float((diff.max(axis=-1) > 1.0 / 255.0).mean())
    print(f"  {label}: mean |d| {mean:.3e}, pixels off by >1/255 {frac:.3e}",
          flush=True)
    check(mean <= IMG_MEAN and frac <= IMG_FRAC,
          f"{label} within mean {IMG_MEAN} and {IMG_FRAC:.1%} of pixels")


def hits_agreement(hp, hb, label):
    m_b, m_p = np.asarray(hb.hit), np.asarray(hp.hit)
    id_b, id_p = np.asarray(hb.tri), np.asarray(hp.tri)
    same = (m_b == m_p) & (~m_b | (id_b == id_p))
    frac = float(same.mean())
    both = m_b & m_p & (id_b == id_p)
    t_b, t_p = np.asarray(hb.t)[both], np.asarray(hp.t)[both]
    t_err = float(np.max(np.abs(t_p - t_b) / np.maximum(t_b, 1e-30))
                  ) if both.any() else 0.0
    print(f"  {label}: {m_b.size} rays, hit {m_b.mean():.4f}, masks+ids "
          f"agree {frac:.6f}, max |dt|/t {t_err:.2e}", flush=True)
    check(frac >= NEAREST_AGREE, f"{label} masks and ids agree >= "
          f"{NEAREST_AGREE}")
    check(t_err <= T_REL, f"{label} |dt| <= {T_REL} t where ids agree")


def chunked(fn, n, size, *arrays):
    """Apply fn to row chunks of `arrays` (bounds the oracle's
    intermediates) and concatenate the pytree results."""
    import jax
    import jax.numpy as jnp

    outs = [fn(*(a[i:i + size] for a in arrays)) for i in range(0, n, size)]
    return jax.tree_util.tree_map(lambda *x: jnp.concatenate(x), *outs)


def phase_device():
    import jax

    print("phase 1: device", flush=True)
    dev = jax.devices()
    if dev[0].platform != "gpu":
        print(f"no GPU: JAX's default device is {dev[0].platform!r}",
              file=sys.stderr)
        sys.exit(2)
    print(f"  device_kind {dev[0].device_kind}, count {len(dev)}",
          flush=True)
    card = card_line()
    print(f"  card: {card}", flush=True)
    return card


def phase_walk():
    import jax
    import jax.numpy as jnp

    from raytracing_tpu.accel.packets import build_cluster_accel
    from raytracing_tpu.config import RenderConfig
    from raytracing_tpu.geometry.mesh import triangle_soa
    from raytracing_tpu.geometry.scene import (
        build_default_scene, subdivided_teapot_mesh)
    from raytracing_tpu.kernels.traverse import (
        any_hit_pallas, nearest_hit_pallas)
    from raytracing_tpu.models.camera import block_ray_ids, camera_rays_for_ids
    from raytracing_tpu.ops.linalg import dot, normalize
    from raytracing_tpu.ops.trace import any_hit_brute, nearest_hit_brute

    print("phase 2: walk vs oracle", flush=True)
    cfg = RenderConfig()
    scene = build_default_scene(t=0.0)
    mesh = scene.mesh
    accel = build_cluster_accel(mesh)
    r = cfg.width * cfg.height * cfg.samples_per_pixel
    o, d = jax.jit(lambda i: camera_rays_for_ids(i, cfg))(
        block_ray_ids(0, r, cfg))
    tri = triangle_soa(mesh.verts, mesh.tri_v)
    walk = jax.jit(lambda o_, d_: nearest_hit_pallas(mesh, accel, o_, d_))
    hp, t_first = timed(walk, o, d)
    _, t_walk = timed(walk, o, d)
    brute = jax.jit(lambda o_, d_: nearest_hit_brute(tri, o_, d_))
    hb = chunked(brute, r, 1 << 18, o, d)
    print(f"  primaries: walk {t_walk * 1e3:.3f} ms "
          f"(first call {t_first:.2f} s)", flush=True)
    hits_agreement(hp, hb, "primaries, nearest")

    @jax.jit
    def shadow_rays(t, tri_id, hit):
        n = mesh.normals[tri_id]
        pos = o + jnp.where(hit, t, 1.0)[:, None] * d + n * cfg.normal_offset
        sd = normalize(scene.sun - pos, eps=1e-20)
        return pos, sd, hit & (dot(n, sd) > 0.0)

    so, sd, alive = shadow_rays(hb.t, hb.tri, hb.hit)
    occ_walk = jax.jit(lambda o_, d_, a_: any_hit_pallas(
        mesh, accel, o_, d_, alive=a_))
    occ_p, _ = timed(occ_walk, so, sd, alive)
    _, t_occ = timed(occ_walk, so, sd, alive)
    occ_b = chunked(jax.jit(lambda o_, d_: any_hit_brute(tri, o_, d_)),
                    r, 1 << 18, so, sd)
    a = np.asarray(alive)
    frac = float((np.asarray(occ_p)[a] == np.asarray(occ_b)[a]).mean())
    print(f"  shadow rays: {int(a.sum())} alive, occluded "
          f"{np.asarray(occ_b)[a].mean():.4f}, walk {t_occ * 1e3:.3f} ms, "
          f"agree {frac:.6f}", flush=True)
    check(frac >= NEAREST_AGREE, f"shadow occlusion agrees >= {NEAREST_AGREE}")

    t0 = time.perf_counter()
    big = subdivided_teapot_mesh(levels=4)
    big_accel = build_cluster_accel(big)
    print(f"  {big.num_triangles} triangles, {big_accel.num_clusters} "
          f"clusters of {big_accel.cluster_size}, mesh + build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sub = jnp.asarray(np.arange(0, r, max(1, r // 65536))[:65536])
    ob, db = o[sub], d[sub]
    big_tri = triangle_soa(big.verts, big.tri_v)
    hp_big, _ = timed(jax.jit(lambda o_, d_: nearest_hit_pallas(
        big, big_accel, o_, d_)), ob, db)
    hb_big = chunked(jax.jit(lambda o_, d_: nearest_hit_brute(
        big_tri, o_, d_, block=2048)), ob.shape[0], 8192, ob, db)
    hits_agreement(hp_big, hb_big, "1.6M-triangle teapot, nearest")


def phase_frame(card):
    import jax

    from raytracing_tpu.accel.packets import build_cluster_accel
    from raytracing_tpu.config import RenderConfig
    from raytracing_tpu.geometry.scene import build_default_scene
    from raytracing_tpu.models.whitted import render
    from raytracing_tpu.tracer import resolve_backend

    print("phase 3: reference frame", flush=True)
    scene = build_default_scene(t=0.0)
    accel = build_cluster_accel(scene.mesh)
    cfg = RenderConfig(backend="auto")
    print(f"  auto resolves to {resolve_backend('auto')!r}", flush=True)

    def frame(c, key):
        return render(scene, c, accel=accel, key=jax.random.PRNGKey(key))

    times = {}
    for backend in ("auto", "cluster"):
        c = cfg.replace(backend=backend)
        img, first = timed(frame, c, 0)
        _, t = timed(frame, c, 1)
        times[backend] = t
        print(f"  frame {c.width}x{c.height}x{c.samples_per_pixel}spp, "
              f"backend {backend}: {t:.3f} s "
              f"(first call incl. compile {first:.1f} s) on {card}",
              flush=True)
        if backend == "auto":
            img_auto = np.asarray(img)
        else:
            img_cluster = np.asarray(img)
    check(np.isfinite(img_auto).all(), "frame has no NaN")
    sky = (np.array([0x87, 0xCE, 0xEB]) / 255.0) ** (1 / 2.2)
    check(np.abs(img_auto[2, 2] - sky).max() <= 1e-3,
          "sky pixel equals gamma(#87ceeb) within 1e-3")
    image_agreement(img_auto, img_cluster, "auto vs cluster frame")

    small = cfg.replace(width=128, height=128)
    img_s = render(scene, small, accel=accel, key=jax.random.PRNGKey(3))
    img_b = render(scene, small.replace(backend="bruteforce"),
                   key=jax.random.PRNGKey(3))
    image_agreement(img_s, img_b, "128x128 auto vs bruteforce")
    return scene, accel, cfg, times


def phase_fit(scene, accel):
    import jax
    import jax.numpy as jnp

    from raytracing_tpu.config import RenderConfig
    from raytracing_tpu.models import inverse
    from raytracing_tpu.models.camera import camera_rays
    from raytracing_tpu.models.whitted import render, render_rays

    print("phase 4: fit", flush=True)
    cfg = RenderConfig(width=256, height=256, backend="auto")
    target = render(scene, cfg, accel=accel, key=jax.random.PRNGKey(0))
    mesh = scene.mesh
    params = {"verts": mesh.verts * 1.002, "colors": mesh.colors * 0.5}
    res = inverse.fit(scene, target, params, cfg, accel=accel, steps=3,
                      rays_per_step=8192)
    print(f"  losses {res.losses}", flush=True)
    check(np.isfinite(res.losses).all(), "fit losses are finite")
    check(res.losses[-1] < res.losses[0], "fit loss falls over 3 steps")

    # 512 rays: the bruteforce backend's backward pass keeps every
    # triangle block's residuals for every ray of every level.
    o, d = camera_rays(cfg)
    n_all = o.size // 3
    idx = jnp.asarray(np.arange(0, n_all, n_all // 512)[:512])
    o, d = o.reshape(-1, 3)[idx], d.reshape(-1, 3)[idx]
    tgt = jnp.broadcast_to(target[None], (cfg.samples_per_pixel,)
                           + target.shape).reshape(-1, 3)[idx]

    def grads(c, acc):
        def loss(verts, colors):
            m = mesh._replace(verts=verts, colors=colors)
            rgb = render_rays(m, acc, scene.sun, o, d,
                              jax.random.PRNGKey(1), c)
            return jnp.mean((rgb - tgt) ** 2)
        return jax.jit(jax.grad(loss, argnums=(0, 1)))(
            mesh.verts, params["colors"])

    g_walk = grads(cfg, accel)
    g_brute = grads(cfg.replace(backend="bruteforce"), None)
    for name, gw, gb in zip(("verts", "colors"), g_walk, g_brute):
        gw, gb = np.asarray(gw), np.asarray(gb)
        rel = float(np.linalg.norm(gw - gb) / max(np.linalg.norm(gb), 1e-30))
        print(f"  d loss / d {name}: relative L2 error {rel:.2e}",
              flush=True)
        check(np.isfinite(gw).all() and rel <= GRAD_REL,
              f"{name} gradients match bruteforce within {GRAD_REL}")


def phase_memory(scene, accel, cfg):
    import jax

    from raytracing_tpu.models.whitted import _cached_body, frame_program

    print("phase 5: memory", flush=True)
    prog = frame_program(scene, cfg, accel)
    body = _cached_body(prog.cache_key, prog.make_body, prog.refs)
    key = jax.random.split(jax.random.PRNGKey(0), prog.nc)[0]
    compiled = body.lower(0, key).compile()
    print(f"  chunk program ({prog.chunk} primary rays): "
          f"{compiled.memory_analysis()}", flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
          flush=True)


def phase_gpu_tests():
    """The tests marked `gpu`, called in this process (a pytest child
    would need the card this process holds)."""
    import importlib.util
    import itertools

    print("gpu tests", flush=True)
    ran = 0
    tests_dir = os.path.join(HERE, "tests")
    for name in sorted(os.listdir(tests_dir)):
        path = os.path.join(tests_dir, name)
        if not (name.startswith("test_") and name.endswith(".py")
                and "mark.gpu" in open(path).read()):
            continue
        # Loaded by path: another installed package may be named `tests`.
        spec = importlib.util.spec_from_file_location(
            f"_gpu_tests_{name[:-3]}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for fname, fn in vars(mod).items():
            marks = getattr(fn, "pytestmark", [])
            if not (fname.startswith("test_")
                    and any(m.name == "gpu" for m in marks)):
                continue
            axes = []
            for m in marks:
                if m.name == "parametrize":
                    names = [s.strip() for s in m.args[0].split(",")]
                    axes.append([dict(zip(names, v if len(names) > 1
                                          else (v,))) for v in m.args[1]])
            for combo in itertools.product(*axes):
                kw = {k: v for part in combo for k, v in part.items()}
                fn(gpu=None, **kw)
                print(f"  passed {name}::{fname}{kw}", flush=True)
                ran += 1
    check(ran > 0, f"{ran} gpu-marked test cases pass")


def phase_four_cards():
    import jax
    import jax.numpy as jnp
    import optax

    from raytracing_tpu.accel.packets import build_cluster_accel
    from raytracing_tpu.config import RenderConfig
    from raytracing_tpu.geometry.scene import build_default_scene
    from raytracing_tpu.models.camera import camera_rays_for_ids
    from raytracing_tpu.models.whitted import render, render_rays
    from raytracing_tpu.parallel.shard import (
        make_device_mesh, make_train_step, render_sharded)

    print("phase 4-card: render_sharded and make_train_step", flush=True)
    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found "
                           f"{len(jax.devices())}")
    scene = build_default_scene(t=0.0)
    accel = build_cluster_accel(scene.mesh)
    cfg = RenderConfig(backend="auto")
    mesh4 = make_device_mesh(4)
    key = jax.random.PRNGKey(0)
    img4, first = timed(lambda: render_sharded(scene, cfg, mesh4,
                                               accel=accel, key=key))
    _, t4 = timed(lambda: render_sharded(scene, cfg, mesh4, accel=accel,
                                         key=key))
    img1, _ = timed(lambda: render(scene, cfg, accel=accel, key=key))
    _, t1 = timed(lambda: render(scene, cfg, accel=accel, key=key))
    print(f"  frame {cfg.width}x{cfg.height}: 4 cards {t4:.3f} s "
          f"(first {first:.1f} s), "
          f"1 card {t1:.3f} s", flush=True)
    check(np.isfinite(np.asarray(img4)).all(), "4-card frame has no NaN")
    image_agreement(img4, img1, "render_sharded(4) vs render(1)")

    # One train step. diffuse_depth=1 spawns no diffuse rays, so the step
    # draws no random numbers and its per-device key folding cannot make
    # 4 cards differ from 1.
    tcfg = cfg.replace(width=128, height=128, diffuse_depth=1)
    r = tcfg.width * tcfg.height * tcfg.samples_per_pixel
    o, d = camera_rays_for_ids(jnp.arange(0, r, r // 8192, dtype=jnp.int32),
                               tcfg)
    target = render_rays(scene.mesh, accel, scene.sun, o, d, key, tcfg)
    params = {"verts": scene.mesh.verts, "colors": scene.mesh.colors * 0.5}
    opt = optax.sgd(1e-2)
    outs = {}
    for n in (1, 4):
        step = make_train_step(tcfg, opt, make_device_mesh(n))
        outs[n] = jax.block_until_ready(step(
            params, opt.init(params), scene.mesh, accel, scene.sun, o, d,
            target, key))
    l1, l4 = float(outs[1][2]), float(outs[4][2])
    print(f"  train step loss: 1 card {l1:.8e}, 4 cards {l4:.8e}", flush=True)
    check(l1 > 0.0 and abs(l4 - l1) <= 1e-5 * l1,
          "4-card loss equals 1-card loss within 1e-5 relative")
    for k in params:
        a, b = np.asarray(outs[4][0][k]), np.asarray(outs[1][0][k])
        err = float(np.abs(a - b).max())
        print(f"  params[{k}] max |4 cards - 1 card| {err:.2e}", flush=True)
        check(np.allclose(a, b, rtol=1e-5, atol=1e-6),
              f"4-card {k} equal 1-card {k} within rtol 1e-5, atol 1e-6")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU render_sharded/train-step "
                         "phase")
    args = ap.parse_args()
    os.chdir(HERE)
    sys.path.insert(0, HERE)
    from raytracing_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    card = phase_device()
    # Native host library (structure build), built here for this host.
    subprocess.run(["make", "-B", "-s", "-C", os.path.join(HERE, "csrc")],
                   check=True)
    import jax

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_walk()
        scene, accel, cfg, _ = phase_frame(card)
        phase_fit(scene, accel)
        phase_memory(scene, accel, cfg)
        phase_gpu_tests()
    dev = jax.devices()
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}), flush=True)


if __name__ == "__main__":
    main()
