"""Whitted + one-bounce-diffuse integrator — reference-parity renderer.

This is the accelerator re-design of the reference's recursive `trace_ray`
(/root/reference/src/main.rs:88-311). The recursion (mirror reflection to
REFLECT_DEPTH=4, cosine-hemisphere diffuse fan-out of DIFFUSE_SCATT=10 rays
to DIFFUSE_DEPTH=2) becomes an *iterative wavefront over statically-shaped
ray levels*: level l holds every ray at recursion depth l as one flat batch,
children are appended as [reflect | diffuse] blocks with per-ray RGB weights,
and radiance is accumulated bottom-up. No data-dependent control flow — dead
rays (misses, zero-weight children) are masked lanes.

Feature parity checklist (each item cites the reference behaviour):
  - nearest-hit + hard sun shadows w/ backface "cheat" n·sun>0 (main.rs:189)
  - Lambertian direct light: color * (n·sun) * (albedo/π), sun intensity 1
    (main.rs:235-240; albedo pre-divided by π at Material::new)
  - mirror reflection d - 2n(d·n), weight = reflectivity, depth < 4
    (main.rs:243-257)
  - diffuse GI: 10 cosine-weighted rays, weight = hit_color*(n·ω)*roughness,
    averaged (main.rs:259-299)
  - self-intersection offset n * 1e-5 (main.rs:121-124)
  - miss -> sky #87ceeb (main.rs:302-304)
  - gamma 1/2.2 applied per primary sample at depth 1, *before* the spp
    average (main.rs:306-310 + :365)

Known reference quirks NOT reproduced (documented in SURVEY.md §2.4): the
stale-`closest` rest-triangle bug (main.rs:157-169) and the integer aspect
ratio (main.rs:314) — both are bugs, not capabilities.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from raytracing_tpu.accel.packets import ClusterAccel
from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Mesh, Scene
from raytracing_tpu.ops.color import gamma_correct
from raytracing_tpu.ops.intersect import reflect, triangle_normal
from raytracing_tpu.ops.linalg import dot, normalize
from raytracing_tpu.ops.sampling import cosine_hemisphere
from raytracing_tpu.kernels.binning import (
    batch_bounds,
    bin_key,
    bin_sort,
    bounce_bin_key,
    unsort,
)
from raytracing_tpu.ops.trace import Hit
from raytracing_tpu.tracer import any_hit, nearest_hit, resolve_backend


def _attribute_rows(mesh: Mesh) -> jnp.ndarray:
    """Per-triangle shading attributes as one [T, 9] row table:
    normal(3) | color(3) | albedo/pi, reflectivity, roughness."""
    return jnp.concatenate(
        [mesh.normals, mesh.colors, mesh.materials[mesh.obj_id]], axis=1
    )


class Shaded(NamedTuple):
    """Per-ray shading state at one wavefront level (all sanitized: finite
    even on miss lanes, so downstream where() masks can't see NaNs)."""

    direct: jnp.ndarray  # [N, 3] direct sun radiance (0 unless lit)
    n: jnp.ndarray       # [N, 3] shading normal
    pos: jnp.ndarray     # [N, 3] offset hit position
    color: jnp.ndarray   # [N, 3] triangle base color
    refl: jnp.ndarray    # [N] material reflectivity
    rough: jnp.ndarray   # [N] material roughness (diffuse weight)
    albedo_pi: jnp.ndarray  # [N] albedo / pi (Lambertian BRDF factor)


def shade(
    mesh: Mesh,
    accel: Optional[ClusterAccel],
    sun: jnp.ndarray,
    o: jnp.ndarray,
    d: jnp.ndarray,
    hit: Hit,
    config: RenderConfig,
    bin_shadow: Optional[bool] = None,
) -> Shaded:
    """Direct lighting at hit points, incl. the shadow (any-hit) query —
    the reference's main.rs:176-241 in batch form. One fused row gather
    by triangle id fetches all 9 per-triangle shading attributes from the
    live mesh tables (differentiable w.r.t. normals, colors and
    materials)."""
    # Miss lanes carry tri id 0 / t=1.0: harmless garbage killed by masks.
    t_safe = jnp.where(hit.hit, hit.t, 1.0)
    idx = hit.tri
    attrs = jnp.take(_attribute_rows(mesh), idx, axis=0)  # [N, 9]
    if config.normals == "geometric":
        # Geometric normals depend on live verts for autodiff.
        tv = mesh.tri_v[idx]
        n = triangle_normal(
            mesh.verts[tv[:, 0]], mesh.verts[tv[:, 1]], mesh.verts[tv[:, 2]]
        )
    else:
        n = attrs[:, 0:3]
    pos = o + t_safe[:, None] * d + n * config.normal_offset
    color = attrs[:, 3:6]
    albedo_pi, refl, rough = attrs[:, 6], attrs[:, 7], attrs[:, 8]

    sun_dir = normalize(sun - pos, eps=1e-20)
    ndl = dot(n, sun_dir)
    facing = ndl > 0.0  # the reference's backface "cheat" (main.rs:189)
    # Shadow rays only matter where they can change the result; mark the
    # rest dead (miss lanes and backfacing hits) — the wavefront carries
    # them at static shape, but the walk leaves dead lanes out of its
    # block decisions and all-dead blocks trace for free. With bin_shadow
    # the query is re-sorted by HIT POSITION cell: the caller's ray order
    # groups by ray origin/direction, but the shadow rays START at the hit
    # points, which scatter across the scene for GI levels — unsorted,
    # their block frustums balloon and visit lists overflow to full
    # cluster scans. Only pos+alive ride the sort; sun_dir is re-derived
    # from the sorted positions.
    sh_alive = hit.hit & facing
    if bin_shadow is None:  # lone callers: "auto" (no gi_accel) -> re-bin
        bin_shadow = config.bin_shadow in (True, "auto")
    if (resolve_backend(config.backend) == "pallas" and accel is not None
            and bin_shadow):
        lo, hi = batch_bounds(pos, sh_alive)
        k = bin_key(pos, sun_dir, lo, hi, sh_alive)
        sidx, (pos_s, alive_s) = bin_sort(k, pos, sh_alive)
        dir_s = normalize(sun - pos_s, eps=1e-20)
        occ_s = any_hit(mesh, accel, pos_s, dir_s, config, alive=alive_s)
        (occluded,) = unsort(sidx, occ_s)
    else:
        occluded = any_hit(mesh, accel, pos, sun_dir, config,
                           alive=sh_alive)
    lit = hit.hit & facing & ~occluded
    direct = jnp.where(
        lit[:, None], color * (ndl * albedo_pi)[:, None], 0.0
    )
    return Shaded(direct=direct, n=n, pos=pos, color=color, refl=refl,
                  rough=rough, albedo_pi=albedo_pi)


def area_light_term(
    mesh: Mesh,
    accel: Optional[ClusterAccel],
    lights,
    sh: Shaded,
    hit_mask: jnp.ndarray,
    key: jax.Array,
    config: RenderConfig,
) -> jnp.ndarray:
    """Soft-shadowed direct radiance from spherical area lights [N, 3] —
    the feature the reference stubbed out (`lights: Vec::new(), // TODO`,
    main.rs:462) plus penumbras it never had (BASELINE config 4).

    Per light: uniform solid-angle cone sampling (ops/sampling.sample_cone)
    with config.light_samples visibility rays each; the estimator is
    mean(emission * cos_theta * V) * cone_solid_angle * albedo/pi * color.
    Visibility is a true any-hit query bounded per ray by the ray-sphere
    distance to the light surface (the walk kernel's per-ray t_max row) —
    occluders beyond the light never count, and the query early-outs like
    the reference's shadow walk (main.rs:176-234). Differentiable w.r.t.
    light center/radius/emission and the shading inputs; visibility stays
    detached like every traversal decision."""
    from raytracing_tpu.ops.intersect import ray_sphere
    from raytracing_tpu.ops.sampling import sample_cone

    pos, n = sh.pos, sh.n
    total = jnp.zeros_like(pos)
    n_lights = lights.center.shape[0]
    for li in range(n_lights):
        c = lights.center[li]
        rad = lights.radius[li]
        em = lights.emission[li]
        to_c = c - pos
        dist = jnp.sqrt(jnp.sum(to_c * to_c, axis=-1))
        axis = to_c / jnp.maximum(dist, 1e-20)[:, None]
        sin_max = jnp.clip(rad / jnp.maximum(dist, 1e-20), 0.0, 1.0)
        cos_max = jnp.sqrt(jnp.maximum(1.0 - sin_max * sin_max, 0.0))
        omega = 2.0 * jnp.pi * (1.0 - cos_max)  # subtended solid angle
        acc = jnp.zeros_like(pos[:, 0])
        for s in range(config.light_samples):
            kd = jax.random.fold_in(key, li * 131 + s)
            w_dir = sample_cone(kd, axis, cos_max)
            ndl = dot(n, w_dir)
            alive = hit_mask & (ndl > 0.0)
            # Distance to the light surface along the sample direction —
            # the per-ray shadow t_max.
            # Grazing cone-edge samples can numerically miss the sphere;
            # fall back to the center distance as t_max instead of inf so
            # far-beyond-the-light geometry can't darken penumbra edges.
            t_light, l_hit = ray_sphere(pos, w_dir, c, rad, jnp.inf)
            t_light = jnp.where(l_hit, t_light, dist)
            # Runs in the caller's (level-sorted) ray order — see the
            # shadow-query note in `shade`.
            t_stop = t_light * (1.0 - 1e-4)
            occluded = any_hit(mesh, accel, pos, w_dir, config,
                               t_max=t_stop, alive=alive)
            vis = alive & ~occluded
            acc = acc + jnp.where(vis, jnp.maximum(ndl, 0.0), 0.0)
        radiance = (acc / config.light_samples * omega)[:, None] * em[None, :]
        total = total + radiance
    return total * sh.albedo_pi[:, None] * sh.color


def render_rays(
    mesh: Mesh,
    accel: Optional[ClusterAccel],
    sun: jnp.ndarray,
    o: jnp.ndarray,
    d: jnp.ndarray,
    key: jax.Array,
    config: RenderConfig,
    lights=None,
    gi_accel: Optional[ClusterAccel] = None,
) -> jnp.ndarray:
    """Radiance for a batch of primary rays [R, 3] -> gamma-corrected RGB
    [R, 3]. The full ray tree is unrolled into max_depth wavefront levels.

    gi_accel: optional SECOND accel (same mesh, typically coarser
    clusters) used for every depth>1 level — trace, sun shadow, and area
    lights. Results are exact either way (same triangle set; only the
    walk partition changes)."""
    s = config.diffuse_scatter
    sky = jnp.asarray(config.sky_color, dtype=o.dtype)
    bin_sh = (config.bin_shadow if isinstance(config.bin_shadow, bool)
              else gi_accel is None)  # "auto" (see RenderConfig)
    binning = (resolve_backend(config.backend) == "pallas"
               and accel is not None and config.bin_secondary)

    # Recursive wavefront (unrolled at trace time): each level traces +
    # shades its batch and recurses into its children's subtree, which is
    # wrapped in lax.cond on "any child alive" — a chunk whose rays all
    # missed (sky chunks: ~60% of the reference frame) then skips every
    # deeper level's spawn RNG, payload sorts, and traversal at RUNTIME.
    # Exact: dead children enter the parent's estimator with zero weight
    # (w_refl/w_diff are masked by hit), so the skipped subtree could
    # only ever contribute zeros.
    #
    # Sort discipline (unchanged from the iterative form): bounce level l
    # is re-binned ONCE by (origin cell, direction cone) and then LIVES
    # in that sorted frame — trace, sun shadow, area lights, and child
    # spawning all run sorted. Only the level's 3-column radiance is
    # unsorted on the way out, handing contributions back in the parent's
    # frame.
    def level_radiance(o_l, d_l, alive_l, depth):
        n_l = o_l.shape[0]
        sidx = None
        # Coarse-cluster accel for the incoherent bounce levels, when the
        # caller provides one.
        acc_l = gi_accel if (depth > 1 and gi_accel is not None) else accel
        if (depth > 1 and binning
                # Levels past diffuse_depth hold only reflect children —
                # see bin_reflect_levels.
                and (depth <= config.diffuse_depth
                     or config.bin_reflect_levels)):
            # Quantize over the batch's own live origins, not the scene
            # box: with the ±10,000 ground plane in the scene box every
            # visible bounce origin shares one 2,500-unit Morton cell and
            # position binning does nothing (see binning.batch_bounds).
            lo_, hi_ = batch_bounds(o_l, alive_l)
            k = bounce_bin_key(o_l, d_l, lo_, hi_, alive_l)
            sidx, (o_l, d_l, alive_l) = bin_sort(k, o_l, d_l, alive_l)
        h = nearest_hit(mesh, acc_l, o_l, d_l, config, alive=alive_l)
        sh = shade(mesh, acc_l, sun, o_l, d_l, h, config, bin_shadow=bin_sh)
        direct = sh.direct
        if lights is not None:
            kl = jax.random.fold_in(key, 7777 + depth)
            area = area_light_term(mesh, acc_l, lights, sh, h.hit, kl,
                                   config)
            direct = direct + jnp.where(h.hit[:, None], area, 0.0)
        has_r = depth < config.reflect_depth
        has_d = depth < config.diffuse_depth
        contrib = direct
        if has_r or has_d:
            parts_o, parts_d, parts_a = [], [], []
            if has_r:
                # Children with zero throughput are dead on arrival; keep
                # the slot (static wavefront shape) but mark it dead.
                parts_o.append(sh.pos)
                parts_d.append(reflect(d_l, sh.n))
                parts_a.append(h.hit & (sh.refl > 0.0))
                w_refl = jnp.where(h.hit[:, None], sh.refl[:, None], 0.0)
            if has_d:
                kd = jax.random.fold_in(key, depth)
                wdirs = cosine_hemisphere(kd, sh.n, shape=(s,))  # [s,N,3]
                cosj = dot(jnp.broadcast_to(sh.n[None], wdirs.shape),
                           wdirs)
                w_d = sh.color[None] * (cosj * sh.rough[None])[..., None]
                w_diff = jnp.where(h.hit[None, :, None], w_d, 0.0)
                parts_o.append(jnp.broadcast_to(
                    sh.pos[None], (s, n_l, 3)).reshape(s * n_l, 3))
                parts_d.append(wdirs.reshape(s * n_l, 3))
                parts_a.append(jnp.broadcast_to(
                    (h.hit & (sh.rough > 0.0))[None],
                    (s, n_l)).reshape(s * n_l))
            o_c = jnp.concatenate(parts_o, axis=0)
            d_c = jnp.concatenate(parts_d, axis=0)
            a_c = jnp.concatenate(parts_a, axis=0)

            def subtree(args):
                return level_radiance(*args, depth + 1)

            def dead(args):
                return jnp.zeros((a_c.shape[0], 3), o_c.dtype)

            rad_c = jax.lax.cond(jnp.any(a_c), subtree, dead,
                                 (o_c, d_c, a_c))
            off = 0
            if has_r:
                contrib = contrib + w_refl * rad_c[:n_l]
                off = n_l
            if has_d:
                rd = rad_c[off:].reshape(s, n_l, 3)
                contrib = contrib + jnp.mean(w_diff * rd, axis=0)
        rad = jnp.where(h.hit[:, None], contrib, sky)
        if sidx is not None:
            (rad,) = unsort(sidx, rad)
        return rad

    rad = level_radiance(o, d, None, 1)
    return gamma_correct(rad, config.gamma)


# Chunk dispatch window: chunk programs enqueued per host-side burst before
# a device sync. Each program's only per-call arguments are scalars (chunk
# index + RNG key) — ray data for chunk i is derived ON DEVICE from i
# (camera_rays_for_ids) — and each burst's outputs fold into one donated
# accumulator, so the host never runs unboundedly ahead of the device and
# the live-buffer set stays bounded.
CHUNK_BURST = 26


@partial(jax.jit, donate_argnums=(0,))
def _fold(acc, lo, *chunks):
    return jax.lax.dynamic_update_slice(acc, jnp.concatenate(chunks, 0),
                                        (lo, 0))


# Compiled chunk-program cache. The chunk body closes over scene/accel
# arrays (captured constants) so it cannot be a plain top-level jit;
# re-jitting a fresh closure every render() call would recompile per
# frame. Keyed on the identity of the scene/accel buffers + the static
# config. LRU: an animate loop alternating more than _BODY_CACHE_MAX
# configs evicts the stalest entry, not the whole cache.
from collections import OrderedDict

_BODY_CACHE: OrderedDict = OrderedDict()
_BODY_CACHE_MAX = 16


def _cached_body(cache_key, make, refs):
    """refs: the objects whose id()s appear in cache_key — stored so a
    freed object's address can't be recycled while its entry lives."""
    hit = _BODY_CACHE.get(cache_key)
    if hit is not None:
        _BODY_CACHE.move_to_end(cache_key)
        return hit[0]
    if len(_BODY_CACHE) >= _BODY_CACHE_MAX:
        _BODY_CACHE.popitem(last=False)
    fn = jax.jit(make())
    _BODY_CACHE[cache_key] = (fn, refs)
    return fn


def _dispatch_chunks(body, keys, nc, chunk, width=3):
    """Windowed burst dispatch of per-chunk programs `body(i, key)` (see
    CHUNK_BURST), folding results into ONE donated device accumulator per
    burst."""
    acc = jnp.zeros((nc * chunk, width), jnp.float32)
    for lo in range(0, nc, CHUNK_BURST):
        hi = min(lo + CHUNK_BURST, nc)
        burst = [body(i, keys[i]) for i in range(lo, hi)]
        acc = _fold(acc, lo * chunk, *burst)
        del burst
        jax.block_until_ready(acc)
    return acc


# Auto-built coarse bounce accels, keyed on (mesh id, cluster size). The
# build is host-side and must not recur per frame; entries keep a mesh ref
# so a freed mesh's id can't be recycled. LRU like _BODY_CACHE.
_GI_ACCEL_CACHE: OrderedDict = OrderedDict()
_GI_ACCEL_CACHE_MAX = 8


def _auto_gi_accel(mesh: Mesh, accel: Optional[ClusterAccel],
                   config: RenderConfig) -> Optional[ClusterAccel]:
    """Coarse second accel for the incoherent bounce levels (see
    config.gi_cluster_size). Built once per (mesh, size) and cached;
    skipped when disabled (size 0), when the backend doesn't use it, or
    when the primary accel is already at least that coarse (the build
    would duplicate it)."""
    cs = config.gi_cluster_size
    if (cs <= 0 or accel is None
            or resolve_backend(config.backend) != "pallas"
            or accel.cluster_size >= cs):
        return None
    ck = (id(mesh), cs)
    hit = _GI_ACCEL_CACHE.get(ck)
    if hit is not None:
        _GI_ACCEL_CACHE.move_to_end(ck)
        return hit[0]
    from raytracing_tpu.accel.packets import build_cluster_accel

    if len(_GI_ACCEL_CACHE) >= _GI_ACCEL_CACHE_MAX:
        _GI_ACCEL_CACHE.popitem(last=False)
    gi = build_cluster_accel(mesh, cluster_size=cs)
    _GI_ACCEL_CACHE[ck] = (gi, mesh)
    return gi


class FrameProgram(NamedTuple):
    """A frame cut into `nc` chunk programs of `chunk` primary rays:
    make_body() -> body(i, key) returns chunk i's gamma-corrected samples
    [chunk, 3]; finish(rgb [nc*chunk, 3]) assembles the [H, W, 3] image.
    cache_key / refs identify the compiled body (see _cached_body)."""

    make_body: object
    chunk: int
    nc: int
    finish: object
    cache_key: tuple
    refs: tuple


def frame_program(scene: Scene, config: RenderConfig,
                  accel: Optional[ClusterAccel] = None,
                  gi_accel: Optional[ClusterAccel] = None) -> FrameProgram:
    """The chunk decomposition shared by `render` (one device, bursts of
    chunk programs) and parallel.shard.render_sharded (chunks spread over
    a device mesh): both run the same per-chunk program with the same
    per-chunk keys, so their images agree."""
    spp, h, w = config.samples_per_pixel, config.height, config.width
    r = spp * h * w
    # Pixel-block ray order: the walk culls per block of consecutive rays,
    # and a 16x16-pixel block's frustum intersects ~3x fewer clusters than
    # a flat scanline strip. Applied on EVERY backend (it is order-only) so
    # the per-ray RNG assignment — and therefore the rendered image — is
    # identical across backends. When the frame divides into whole blocks
    # the permutation and its inverse are pure index arithmetic
    # (block_ray_ids / blocks_to_image) so the chunk program captures NO
    # frame-sized constants; odd sizes fall back to the explicit table.
    from raytracing_tpu.models.camera import (
        block_permutation, block_ray_ids, blocks_to_image,
        camera_rays_for_ids,
    )

    bh = bw = 16
    by_formula = (h % bh == 0) and (w % bw == 0)
    chunk = min(config.chunk_size, r)
    nc = (r + chunk - 1) // chunk
    lights = getattr(scene, "lights", None)
    ckey = (id(scene.mesh), id(accel), id(gi_accel), id(scene.sun),
            id(lights), config, chunk, by_formula)
    refs = (scene, accel, gi_accel)

    def trace_ids(ids, key_c):
        o_c, d_c = camera_rays_for_ids(ids, config)
        return render_rays(scene.mesh, accel, scene.sun, o_c, d_c, key_c,
                           config, lights=lights, gi_accel=gi_accel)

    if by_formula:
        def make():
            return lambda i, key_c: trace_ids(
                block_ray_ids(i, chunk, config, bh, bw), key_c)

        # Per-sample gamma already applied (reference order); average spp.
        return FrameProgram(make, chunk, nc,
                            lambda rgb: blocks_to_image(rgb[:r], config,
                                                        bh, bw),
                            ckey, refs)

    perm, inv = block_permutation(spp, h, w, bh, bw)
    pad = nc * chunk - r
    if pad:  # repeat the last ray id; surplus results are dropped below
        perm = jnp.concatenate([perm, jnp.broadcast_to(perm[-1:], (pad,))])

    def make():
        return lambda i, key_c: trace_ids(
            jax.lax.dynamic_slice(perm, (i * chunk,), (chunk,)), key_c)

    def finish(rgb):
        return rgb[:r][inv].reshape(spp, h, w, 3).mean(axis=0)

    return FrameProgram(make, chunk, nc, finish, ckey, (refs, perm))


def render(
    scene: Scene,
    config: RenderConfig,
    accel: Optional[ClusterAccel] = None,
    key: Optional[jax.Array] = None,
    gi_accel: Optional[ClusterAccel] = None,
) -> jnp.ndarray:
    """Render a full frame -> [H, W, 3] float RGB in [0, 1]-ish.

    Primary rays are processed in chunks of config.chunk_size so peak
    memory stays bounded; each chunk is one device program parameterized
    only by its chunk index (rays generated on device), dispatched in
    bounded host-side bursts — the counterpart of the reference's rayon
    scanline fan-out (main.rs:317-319).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    if gi_accel is None:
        gi_accel = _auto_gi_accel(scene.mesh, accel, config)
    prog = frame_program(scene, config, accel, gi_accel)
    keys = jax.random.split(key, prog.nc)
    body = _cached_body(prog.cache_key, prog.make_body, prog.refs)
    return prog.finish(_dispatch_chunks(body, keys, prog.nc, prog.chunk))
