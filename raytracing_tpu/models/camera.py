"""Pinhole camera ray generation with stratified supersampling.

Reproduces the reference's camera (/root/reference/src/main.rs:313-365):
origin at (0,0,0) looking down +z with the focal plane at z = 1,
xx = (2 (x + ox) / W - 1) * aspect * scale, yy = (1 - 2 (y + oy) / H) * scale,
direction (xx, yy, 1) left UNnormalized (the reference never normalizes
primary rays; t is in dir-length units, shading is unaffected because
normals and light directions are normalized separately). One deliberate fix:
aspect is true float W/H, not the reference's integer division
(main.rs:314, a latent bug for non-square windows; identical at 800x800).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from raytracing_tpu.config import RenderConfig
from raytracing_tpu.ops.sampling import stratified_offsets


def camera_rays(config: RenderConfig, dtype=jnp.float32) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """All primary rays for a frame.

    Returns (o, d) of shape [spp, H, W, 3]. Origins are all zero; kept as an
    array so alternative cameras (offset/animated) slot in transparently.
    """
    w, h, spp = config.width, config.height, config.samples_per_pixel
    aspect = float(w) / float(h)
    offs = stratified_offsets(spp, dtype)  # [spp, 2]
    x = jnp.arange(w, dtype=dtype)
    y = jnp.arange(h, dtype=dtype)
    ox = offs[:, 0][:, None, None]
    oy = offs[:, 1][:, None, None]
    xx = (2.0 * (x[None, None, :] + ox) / w - 1.0) * aspect * config.scale
    yy = (1.0 - 2.0 * (y[None, :, None] + oy) / h) * config.scale
    xx, yy = jnp.broadcast_to(xx, (spp, h, w)), jnp.broadcast_to(yy, (spp, h, w))
    d = jnp.stack([xx, yy, jnp.ones_like(xx)], axis=-1)
    o = jnp.zeros_like(d)
    return o, d


def camera_rays_for_ids(
    ids: jnp.ndarray, config: RenderConfig, dtype=jnp.float32
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Primary rays for FLAT RAY IDS (the [spp, H, W] flatten order) —
    bitwise-identical values to `camera_rays(...).reshape(-1, 3)[ids]`.

    This exists so a render chunk can be generated ENTIRELY on device from
    a scalar chunk index: no per-chunk host->device upload of ray buffers.
    """
    import numpy as np

    w, h, spp = config.width, config.height, config.samples_per_pixel
    aspect = float(w) / float(h)
    s = ids // (h * w)
    rem = ids % (h * w)
    y = (rem // w).astype(dtype)
    x = (rem % w).astype(dtype)
    # Select chain over the (static, tiny) spp offset table. Offsets
    # computed host-side in f32 so values match stratified_offsets exactly
    # (same gx x gy grid, any spp).
    from raytracing_tpu.ops.sampling import stratified_grid

    g1, g2 = stratified_grid(spp)
    cx = ((np.arange(g1, dtype=np.float32) + np.float32(0.5))
          / np.float32(g1))
    cy = ((np.arange(g2, dtype=np.float32) + np.float32(0.5))
          / np.float32(g2))
    gx, gy = np.meshgrid(cx, cy, indexing="ij")
    offs_np = list(zip(gx.ravel().tolist(), gy.ravel().tolist()))
    ox = jnp.full_like(x, offs_np[0][0])
    oy = jnp.full_like(y, offs_np[0][1])
    for k in range(1, spp):
        ox = jnp.where(s == k, offs_np[k][0], ox)
        oy = jnp.where(s == k, offs_np[k][1], oy)
    xx = (2.0 * (x + ox) / w - 1.0) * aspect * config.scale
    yy = (1.0 - 2.0 * (y + oy) / h) * config.scale
    d = jnp.stack([xx, yy, jnp.ones_like(xx)], axis=-1)
    return jnp.zeros_like(d), d


def block_ray_ids(
    i, chunk: int, config: RenderConfig, block_h: int = 16, block_w: int = 16
) -> jnp.ndarray:
    """Flat ray ids of chunk `i` of the block permutation, BY FORMULA —
    exactly `block_permutation(spp, h, w, bh, bw)[0][i*chunk:(i+1)*chunk]`
    when bh | H and bw | W (asserted by the caller).

    Why a formula and not the table: a captured [spp*H*W] permutation
    constant is ~10 MB, and executables whose captured constants exceed
    the runtime's staging cache get them re-sent per call (~170 ms/chunk
    measured, 50x the chunk's compute). Index arithmetic costs nothing
    and keeps the chunk program's footprint at the few-MB scene tables.
    Ids past the frame end clamp to the last ray (padding tail; callers
    drop those rows)."""
    spp, h, w = config.samples_per_pixel, config.height, config.width
    run = spp * block_h * block_w
    nbx = w // block_w
    idx = i * chunk + jnp.arange(chunk, dtype=jnp.int32)
    idx = jnp.minimum(idx, spp * h * w - 1)
    b = idx // run
    r = idx % run
    s = r // (block_h * block_w)
    p = r % (block_h * block_w)
    by = p // block_w
    bx = p % block_w
    br = b // nbx
    bc = b % nbx
    y = br * block_h + by
    x = bc * block_w + bx
    return (s * h + y) * w + x


def blocks_to_image(packed: jnp.ndarray, config: RenderConfig,
                    block_h: int = 16, block_w: int = 16) -> jnp.ndarray:
    """Invert the block permutation and average spp — via reshape/transpose
    ONLY (no gather): packed [spp*H*W, C] in block order -> [H, W, C] mean
    over samples. Requires bh | H and bw | W. Per-sample values (e.g.
    gamma) must already be applied — this just averages."""
    spp, h, w = config.samples_per_pixel, config.height, config.width
    c = packed.shape[-1]
    nby, nbx = h // block_h, w // block_w
    x = packed.reshape(nby, nbx, spp, block_h, block_w, c).mean(axis=2)
    x = x.transpose(0, 2, 1, 3, 4)  # [nby, bh, nbx, bw, c]
    return x.reshape(h, w, c)


def block_permutation(
    spp: int, h: int, w: int, block_h: int = 8, block_w: int = 8
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ray permutation that groups all spp samples of a block_h x block_w
    PIXEL BLOCK into one contiguous run of spp*block_h*block_w rays.

    Rationale: the walk kernel culls the scene per block of consecutive
    rays (kernels/traverse.RAY_BLOCK). In flat [spp, H, W] order a block
    is a 1-pixel-tall scanline strip whose bounding frustum is wide and
    flat; a pixel block subtends a compact frustum and intersects far
    fewer clusters on the reference teapot frame. This is the counterpart
    of the reference's scanline rayon split
    (main.rs:317-319) — the split axis is chosen for culling coherence, not
    thread count.

    Returns (perm, inv) with perm.shape == (spp*h*w,):
      rays_blocked = rays.reshape(-1, 3)[perm]
      result_flat  = result_blocked[inv]
    H/W not divisible by the block are handled by shrinking the last
    blocks (permutation stays exact, tiles just lose some coherence).
    """
    import numpy as np

    idx = np.arange(spp * h * w, dtype=np.int64).reshape(spp, h, w)
    bh, bw = min(block_h, h), min(block_w, w)
    rows = [r for r in range(0, h, bh)]
    cols = [c for c in range(0, w, bw)]
    parts = []
    for r in rows:
        for c in cols:
            parts.append(idx[:, r:r + bh, c:c + bw].reshape(-1))
    perm = np.concatenate(parts)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return jnp.asarray(perm, jnp.int32), jnp.asarray(inv, jnp.int32)
