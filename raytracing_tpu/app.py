"""CLI application shell.

The reference's L4 layer is a winit window + pixels framebuffer free-running
at max fps with an orbiting sun and an fps print (/root/reference/src/
main.rs:381-523), with scene and all parameters hardcoded and a
`// TODO: Use clap` (main.rs:382). This is that layer done properly for a
headless accelerator: subcommands + flags over the same capabilities —

  render   one frame of the default scene -> PNG
  animate  N frames with the orbiting sun (main.rs:479-484), fps print per
           second — the event-loop equivalent, plus optional PNG dumps
  bench    the headline rays/s benchmark (same as bench.py)
  fit      inverse-rendering demo: perturb the scene, recover parameters,
           with checkpoint/resume

Run: python -m raytracing_tpu <subcommand> [flags]
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from typing import Optional

import jax
import numpy as np

from raytracing_tpu.tracer import BACKENDS


def _maybe_init_distributed(args) -> bool:
    """Multi-host wiring (parallel/distributed.py): explicit flags or the
    RTPU_* env vars; a no-op for single-process runs."""
    from raytracing_tpu.parallel.distributed import initialize

    return initialize(
        coordinator_address=getattr(args, "coordinator", None),
        num_processes=getattr(args, "num_processes", None),
        process_id=getattr(args, "process_id", None),
    )


def _build(args):
    from raytracing_tpu.accel.packets import build_cluster_accel
    from raytracing_tpu.config import RenderConfig
    from raytracing_tpu.geometry.scene import build_default_scene
    from raytracing_tpu.tracer import resolve_backend

    cfg = RenderConfig(
        width=args.width, height=args.height,
        samples_per_pixel=args.spp, backend=resolve_backend(args.backend),
        chunk_size=args.chunk_size,
        reflect_depth=args.reflect_depth, diffuse_depth=args.diffuse_depth,
        diffuse_scatter=args.diffuse_scatter,
    )
    scene = build_default_scene(t=0.0, obj_path=args.obj)
    accel = gi_accel = None
    if cfg.backend != "bruteforce":
        import os

        from raytracing_tpu.accel.packets import load_accel, save_accel

        cache = getattr(args, "accel_cache", None)
        if cache and os.path.exists(cache):
            # Validated load: a cache built from a different --obj mesh or
            # --cluster-size raises instead of silently rendering stale
            # geometry.
            accel = load_accel(cache, mesh=scene.mesh,
                               cluster_size=args.cluster_size)
        else:
            accel = build_cluster_accel(scene.mesh,
                                        cluster_size=args.cluster_size)
            if cache:
                save_accel(cache, accel, mesh=scene.mesh)
        gi_cs = getattr(args, "gi_cluster_size", None)
        if gi_cs:
            # Coarser second accel for the incoherent bounce levels (see
            # whitted.render_rays gi_accel) — same triangles, identical
            # image, fewer per-visit fixed costs on GI tiles.
            gi_accel = build_cluster_accel(scene.mesh, cluster_size=gi_cs)
    return cfg, scene, accel, gi_accel


def cmd_render(args) -> None:
    from raytracing_tpu.models.whitted import render
    from raytracing_tpu.utils.image import write_png
    from raytracing_tpu.utils.profiling import device_summary, profile_trace

    multi = _maybe_init_distributed(args)
    cfg, scene, accel, gi_accel = _build(args)
    print(f"devices: {device_summary()}")
    print(f"triangles: {scene.mesh.num_triangles}")  # main.rs:456-459 parity
    if multi:
        # Multi-host: every process renders only its addressable ray
        # shards and writes them gather-free; stitch offline with
        # parallel.distributed.assemble_shards (or the render once all
        # hosts finished).
        from raytracing_tpu.parallel.distributed import (
            assemble_shards,
            render_distributed,
            save_local_shards,
        )

        t0 = time.perf_counter()
        rgb = render_distributed(scene, cfg, accel=accel, gi_accel=gi_accel,
                                 key=jax.random.PRNGKey(args.seed))
        jax.block_until_ready(rgb)
        dt = time.perf_counter() - t0
        out_dir = args.out + ".shards"
        files = save_local_shards(rgb, out_dir)
        print(f"frame: {dt*1e3:.1f} ms; wrote {len(files)} shard files "
              f"to {out_dir} (process {jax.process_index()})")
        if jax.process_index() == 0 and args.assemble:
            img = assemble_shards(out_dir, cfg)
            write_png(args.out, img)
            print(f"wrote {args.out}")
        return
    with profile_trace(args.profile):
        t0 = time.perf_counter()
        img = render(scene, cfg, accel=accel, key=jax.random.PRNGKey(args.seed),
                     gi_accel=gi_accel)
        img.block_until_ready()
        dt = time.perf_counter() - t0
    rays = cfg.width * cfg.height * cfg.samples_per_pixel
    print(f"frame: {dt*1e3:.1f} ms ({rays/dt/1e6:.2f} M primary rays/s)")
    write_png(args.out, np.asarray(img))
    print(f"wrote {args.out}")


def cmd_animate(args) -> None:
    """Free-running frame loop with the orbiting sun — the reference's
    redraw-driven loop (main.rs:466-506) minus the window."""
    from raytracing_tpu.geometry.mesh import Scene
    from raytracing_tpu.geometry.scene import sun_position
    from raytracing_tpu.models.whitted import render
    from raytracing_tpu.utils.image import write_png
    from raytracing_tpu.utils.profiling import RateMeter

    cfg, scene, accel, gi_accel = _build(args)
    fps = RateMeter("fps")
    viewer = None
    if getattr(args, "live", False):
        from raytracing_tpu.utils.term_view import TermViewer

        viewer = TermViewer(max_cols=getattr(args, "live_cols", 100))
    render_jit = jax.jit(
        lambda mesh, sun, key: render(
            Scene(mesh=mesh, sun=sun), cfg, accel=accel, key=key,
            gi_accel=gi_accel
        )
    )
    def present(frame, t, img):
        # In live mode the fps line rides the viewer's status bar instead
        # of scrolling the animation away.
        fps.tick(emit=None if viewer is not None else print)
        if viewer is not None:
            rate = f"{fps.last_rate:.2f}" if fps.last_rate else "..."
            viewer.show(np.asarray(img),
                        status=f"frame {frame}  t={t:6.2f}s  fps {rate}")
        if args.out_pattern:
            write_png(args.out_pattern.format(frame=frame), np.asarray(img))

    # One frame in flight: present frame n-1 on the host (terminal blit /
    # PNG encode, both pure host work) while the device renders frame n —
    # the headless analog of the reference's free-running redraw loop
    # overlapping its fps print with the GPU blit (main.rs:486-504).
    # Elastic frame loop: a transient device fault (preemption, runtime
    # blip) costs the frame's retries, not the animation — the same
    # with_retry discipline the fit loop uses (utils/resilience.py).
    from raytracing_tpu.utils.resilience import with_retry

    def present_safe(frame, t, img):
        # The render dispatch above is retried, but the frame is ASYNC:
        # a runtime fault can surface only when the host materializes it
        # (np.asarray in present / the final block_until_ready) —
        # re-render the lost frame under the same retry discipline
        # instead of killing the animation.
        try:
            present(frame, t, img)
        except jax.errors.JaxRuntimeError:
            img = with_retry(
                lambda: jax.block_until_ready(
                    render_jit(scene.mesh, sun_position(t),
                               jax.random.PRNGKey(frame))),
                probe=True)
            present(frame, t, img)

    start = time.perf_counter()
    pending = None
    for frame in range(args.frames):
        t = time.perf_counter() - start
        sun = sun_position(t)
        img = with_retry(
            lambda: render_jit(scene.mesh, sun, jax.random.PRNGKey(frame)),
            probe=True)
        if pending is not None:
            present_safe(*pending)
        pending = (frame, t, img)
    if pending is not None:
        present_safe(*pending)
    total = time.perf_counter() - start
    print(f"rendered {args.frames} frames in {total:.2f}s "
          f"({args.frames / total:.2f} fps avg)")


def cmd_bench(args) -> None:
    import bench

    bench.main()


def cmd_fit(args) -> None:
    from raytracing_tpu.models import inverse
    from raytracing_tpu.models.whitted import render
    from raytracing_tpu.utils import checkpoint as ckpt

    import jax.numpy as jnp
    import optax

    cfg, scene, accel, gi_accel = _build(args)
    target = render(scene, cfg, accel=accel, key=jax.random.PRNGKey(0))
    params = {"colors": scene.mesh.colors * args.perturb}
    opt = optax.adam(args.lr)
    start_step = 0
    if args.resume and args.checkpoint:
        try:
            params, _, start_step, _ = ckpt.load(args.checkpoint, params)
            print(f"resumed from {args.checkpoint} @ step {start_step}")
        except FileNotFoundError:
            pass

    def cb(i, loss):
        step = start_step + i
        if step % 20 == 0:
            print(f"step {step}: loss {loss:.3e}")
        if args.checkpoint and step % 50 == 49:
            ckpt.save(args.checkpoint, res_params_holder[0], step=step)

    res_params_holder = [params]
    res = inverse.fit(
        scene, target, params, cfg, accel=accel,
        steps=args.steps, rays_per_step=args.rays_per_step,
        learning_rate=args.lr, optimizer=opt, callback=cb,
    )
    res_params_holder[0] = res.params
    if args.checkpoint:
        ckpt.save(args.checkpoint, res.params, step=start_step + args.steps)
    print(json.dumps({"final_loss": res.losses[-1],
                      "initial_loss": res.losses[0]}))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracing_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--width", type=int, default=800)
        sp.add_argument("--height", type=int, default=800)
        sp.add_argument("--spp", type=int, default=4)
        sp.add_argument("--backend", default="auto",
                        choices=BACKENDS,
                        help="auto = the pallas walk kernel on a CUDA GPU, "
                             "the XLA cluster scan elsewhere")
        sp.add_argument("--cluster-size", type=int, default=32)
        sp.add_argument("--gi-cluster-size", type=int, default=None,
                        help="build a second, coarser accel for bounce "
                             "(depth>1) levels — identical image "
                             "(pallas backend)")
        sp.add_argument("--chunk-size", type=int, default=16384)
        sp.add_argument("--reflect-depth", type=int, default=4)
        sp.add_argument("--diffuse-depth", type=int, default=2)
        sp.add_argument("--diffuse-scatter", type=int, default=10)
        sp.add_argument("--accel-cache", default=None,
                        help="path to a .npz accel cache: load if present, "
                             "else build once and save (accel/packets."
                             "save_accel) — production serving ships the "
                             "built structure with the scene")
        sp.add_argument("--obj", default=None,
                        help="OBJ path (default: bundled teapot)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--profile", default=None,
                        help="jax.profiler trace logdir")
        # Multi-host (jax.distributed) wiring; also via RTPU_COORDINATOR /
        # RTPU_NUM_PROCESSES / RTPU_PROCESS_ID, or --num-processes auto
        # where JAX can detect the cluster.
        sp.add_argument("--coordinator", default=None,
                        help="host:port of process 0")
        sp.add_argument("--num-processes", default=None,
                        help="process count, or 'auto' (cluster "
                             "detection)")
        sp.add_argument("--process-id", type=int, default=None)

    sp = sub.add_parser("render", help="render one frame to PNG")
    common(sp)
    sp.add_argument("--out", default="frame.png")
    sp.add_argument("--assemble", action="store_true",
                    help="(multi-host) process 0 stitches shard files "
                         "after rendering")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("animate", help="N-frame loop w/ orbiting sun + fps")
    common(sp)
    sp.add_argument("--frames", type=int, default=10)
    sp.add_argument("--out-pattern", default=None,
                    help="e.g. out/frame_{frame:03d}.png")
    sp.add_argument("--live", action="store_true",
                    help="ANSI truecolor live view in the terminal (the "
                         "reference's window, headless)")
    sp.add_argument("--live-cols", type=int, default=100,
                    help="max terminal columns for --live")
    sp.set_defaults(fn=cmd_animate)

    sp = sub.add_parser("bench", help="headline rays/s benchmark")
    common(sp)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("fit", help="inverse-rendering demo w/ checkpoints")
    common(sp)
    sp.add_argument("--steps", type=int, default=200)
    sp.add_argument("--rays-per-step", type=int, default=4096)
    sp.add_argument("--lr", type=float, default=1e-2)
    sp.add_argument("--perturb", type=float, default=0.5)
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--resume", action="store_true")
    sp.set_defaults(fn=cmd_fit)
    return p


def main(argv: Optional[list] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    from raytracing_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
