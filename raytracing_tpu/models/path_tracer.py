"""Monte-Carlo path tracer — the scalable sibling of the Whitted integrator.

The reference's integrator (/root/reference/src/main.rs:88-311) is a fixed
recursion tree (1 reflection chain + a 10-ray diffuse fan at depth 1) whose
cost explodes combinatorially with depth. This model family replaces the
tree with the standard iterative single-path formulation: each sample
carries one ray with an RGB throughput, at every bounce it adds next-event
direct light (sun + shadow ray) and stochastically continues as EITHER the
mirror branch or the cosine-weighted diffuse branch — constant memory per
bounce, arbitrary depth, statically-shaped (bounce loop unrolled at trace
time). Noise is traded for samples-per-pixel (BASELINE config 3: 4-bounce,
64 spp).

Material semantics intentionally match the reference's ad-hoc BRDF so both
integrators agree in expectation on shared light paths:
  direct   = color * (n·sun) * (albedo/π) * visibility   (main.rs:235-240)
  mirror   = reflectivity * L(reflect(d, n))              (main.rs:243-257)
  diffuse  = roughness * color ⊙ E_ω[cosθ · L(ω)], ω ~ cosine
             (main.rs:259-299 — the reference weights cosine-SAMPLED rays
             by cosθ again; we reproduce that convention, not textbook
             Lambert, because capability parity means matching its images)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from raytracing_tpu.accel.packets import ClusterAccel
from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Mesh, Scene
from raytracing_tpu.models.camera import camera_rays_for_ids
from raytracing_tpu.models.whitted import _cached_body, _dispatch_chunks, shade
from raytracing_tpu.ops.color import gamma_correct
from raytracing_tpu.ops.intersect import reflect
from raytracing_tpu.ops.sampling import cosine_hemisphere
from raytracing_tpu.tracer import nearest_hit, resolve_backend


@dataclasses.dataclass(frozen=True)
class PathTracerConfig:
    max_bounces: int = 4
    samples_per_pixel: int = 64
    # Probability of taking the mirror branch when both branches are live;
    # importance-sampled per material below.
    min_branch_prob: float = 0.05
    # Re-bin the path state every k-th bounce (1 = every bounce). At 2,
    # odd bounces trace in the previous bounce's frame. NOTE: values
    # != 1 change which position-indexed RNG draw each path receives,
    # so images differ sample-by-sample (statistically equivalent
    # estimator, not bit-equal).
    bin_every: int = 1


def trace_paths(
    mesh: Mesh,
    accel: Optional[ClusterAccel],
    sun: jnp.ndarray,
    o: jnp.ndarray,
    d: jnp.ndarray,
    key: jax.Array,
    config: RenderConfig,
    pt: PathTracerConfig,
    gi_accel: Optional[ClusterAccel] = None,
) -> jnp.ndarray:
    """One radiance sample per ray [R, 3] -> linear RGB [R, 3] (no gamma).

    gi_accel: optional coarser accel for bounce>0 segments (see
    whitted.render_rays) — identical estimator, faster incoherent walks."""
    from raytracing_tpu.kernels.binning import (
        batch_bounds,
        bin_sort,
        bounce_bin_key,
    )

    r = o.shape[0]
    sky = jnp.asarray(config.sky_color, dtype=o.dtype)
    radiance = jnp.zeros((r, 3), dtype=o.dtype)
    throughput = jnp.ones((r, 3), dtype=o.dtype)
    alive = jnp.ones(r, dtype=bool)
    binning = (resolve_backend(config.backend) == "pallas"
               and accel is not None and config.bin_secondary)
    orig = jnp.arange(r, dtype=jnp.int32)

    for bounce in range(pt.max_bounces):
        acc_l = gi_accel if (bounce > 0 and gi_accel is not None) else accel
        if bounce > 0 and binning and (bounce - 1) % pt.bin_every == 0:
            # Re-bin the whole per-path state by (coarse origin cell, fine
            # direction cone) — same GI regime as the Whitted bounce
            # levels; the orig column restores pixel order at the end.
            # Batch-origin bounds, not scene bounds — see whitted.py and
            # binning.batch_bounds (outlier geometry otherwise collapses
            # position binning to one cell).
            lo_, hi_ = batch_bounds(o, alive)
            kb_ = bounce_bin_key(o, d, lo_, hi_, alive)
            _, (o, d, alive, throughput, radiance, orig) = bin_sort(
                kb_, o, d, alive, throughput, radiance, orig)
        h = nearest_hit(mesh, acc_l, o, d, config, alive=alive)
        sh = shade(mesh, acc_l, sun, o, d, h, config)
        hit = h.hit & alive
        # Miss -> sky, path ends.
        radiance = radiance + jnp.where(
            (alive & ~h.hit)[:, None], throughput * sky, 0.0
        )
        # Next-event direct light (shade() already folds in visibility).
        radiance = radiance + jnp.where(hit[:, None],
                                        throughput * sh.direct, 0.0)
        if bounce == pt.max_bounces - 1:
            break
        # Stochastic branch: mirror vs diffuse, importance-proportional.
        kb = jax.random.fold_in(key, 2 * bounce)
        ks = jax.random.fold_in(key, 2 * bounce + 1)
        refl = sh.refl
        rough = sh.rough
        p_spec = jnp.clip(
            refl / jnp.maximum(refl + rough, 1e-6),
            pt.min_branch_prob, 1.0 - pt.min_branch_prob,
        )
        # Dead branches (weight 0) force the other branch.
        p_spec = jnp.where(refl <= 0.0, 0.0, p_spec)
        p_spec = jnp.where(rough <= 0.0, jnp.where(refl > 0.0, 1.0, 0.0),
                           p_spec)
        take_spec = jax.random.uniform(kb, (r,)) < p_spec

        d_spec = reflect(d, sh.n)
        w_spec = (refl / jnp.maximum(p_spec, 1e-6))[:, None]

        d_diff = cosine_hemisphere(ks, sh.n)
        cos = jnp.sum(sh.n * d_diff, axis=-1)
        w_diff = sh.color * (
            cos * rough / jnp.maximum(1.0 - p_spec, 1e-6)
        )[:, None]

        d = jnp.where(take_spec[:, None], d_spec, d_diff)
        o = sh.pos
        w = jnp.where(take_spec[:, None], w_spec, w_diff)
        throughput = throughput * jnp.where(hit[:, None], w, 0.0)
        # Terminate paths with no remaining contribution.
        alive = hit & (jnp.max(throughput, axis=-1) > 0.0) & (
            (refl > 0.0) | (rough > 0.0)
        )

    if binning:
        _, (radiance,) = bin_sort(orig, radiance)
    return radiance


def render(
    scene: Scene,
    config: RenderConfig,
    pt: PathTracerConfig = PathTracerConfig(),
    accel: Optional[ClusterAccel] = None,
    key: Optional[jax.Array] = None,
    gi_accel: Optional[ClusterAccel] = None,
) -> jnp.ndarray:
    """Full-frame path-traced render -> [H, W, 3] gamma-corrected RGB.

    spp comes from pt.samples_per_pixel (pixel-center rays, decorrelated by
    per-sample RNG streams) rather than the Whitted 2x2 grid; gamma is
    applied to the converged mean (a Monte-Carlo estimator must average in
    linear space — applying the reference's per-sample gamma to noisy
    samples would bias the image).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    if gi_accel is None:
        from raytracing_tpu.models.whitted import _auto_gi_accel

        gi_accel = _auto_gi_accel(scene.mesh, accel, config)
    cam_cfg = config.replace(samples_per_pixel=1)
    h, w = config.height, config.width
    r = h * w
    chunk = min(config.chunk_size, r)
    nc = (r + chunk - 1) // chunk

    # One program per chunk, parameterized only by (chunk index, key):
    # rays are generated on device and the spp loop is a device-side scan
    # INSIDE the program; chunks are dispatched in bounded host bursts
    # (see whitted.CHUNK_BURST). The compiled body is cached across
    # render() calls (whitted._cached_body).
    def make():
        def chunk_mean(i, key):
            ids = i * chunk + jnp.arange(chunk, dtype=jnp.int32)
            ids = jnp.minimum(ids, r - 1)  # pad tail repeats the last pixel
            o_c, d_c = camera_rays_for_ids(ids, cam_cfg)

            def sample(acc, key_s):
                rgb = trace_paths(scene.mesh, accel, scene.sun, o_c, d_c,
                                  key_s, config, pt, gi_accel=gi_accel)
                return acc + rgb, None

            acc, _ = jax.lax.scan(
                sample, jnp.zeros((chunk, 3), dtype=jnp.float32),
                jax.random.split(key, pt.samples_per_pixel),
            )
            return acc / pt.samples_per_pixel
        return chunk_mean

    ckey = (id(scene.mesh), id(accel), id(gi_accel), id(scene.sun), config,
            pt, chunk, "pt")
    body = _cached_body(ckey, make, (scene, accel, gi_accel))
    keys = jax.random.split(key, nc)
    mean = _dispatch_chunks(body, keys, nc, chunk)[:r]
    return gamma_correct(mean.reshape(h, w, 3), config.gamma)
