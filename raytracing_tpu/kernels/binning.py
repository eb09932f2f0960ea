"""Wavefront ray binning: sort rays into culling-coherent tiles.

The traversal kernel culls per block of consecutive rays
(kernels/traverse.py): a block's cost is the number of clusters its
bounding frustum touches. Primary rays
arrive pre-tiled by pixel block (models/camera.block_permutation), but
secondary rays inherit their PARENT's order — a shadow/bounce tile then
mixes hit points from different surfaces (a teapot patch and the ground
50 units behind it), and its frustum balloons to cover everything in
between. GPU wavefront tracers solve this with ray sorting (Laine et al.,
"Megakernels Considered Harmful" — public technique); here it is one XLA
sort over a compact integer key:

    key = morton(quantized ray origin) << DIR_BITS | direction_bin

Position Morton puts rays from the same surface patch in the same tile
(shadow rays then form thin beams toward the sun); the direction bin
splits hemisphere-sampled bounce rays into cones so a tile's frustum is a
small box x 1/16th of the sphere instead of a box x everything.

Everything here is permutation bookkeeping — results are gathered back to
the caller's order, so binning is semantically invisible.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

POS_BITS = 6   # per-axis quantization -> 18-bit Morton (64^3 cells)
DIR_BITS = 4   # 3-bit octant + 1 bit dominant-axis split -> 16 cones


def _spread3(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of v so consecutive bits land 3 apart."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3(p: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray,
            bits: int = POS_BITS) -> jnp.ndarray:
    """Morton (Z-order) code of points p [N, 3] quantized to 2^bits cells
    per axis inside the [lo, hi] box (clamped outside)."""
    scale = (2.0 ** bits - 1.0) / jnp.maximum(hi - lo, 1e-20)
    q = jnp.clip((p - lo) * scale, 0.0, 2.0 ** bits - 1.0).astype(jnp.int32)
    return (
        (_spread3(q[:, 0]) << 2)
        | (_spread3(q[:, 1]) << 1)
        | _spread3(q[:, 2])
    )


def direction_bin(d: jnp.ndarray) -> jnp.ndarray:
    """16-cone direction bin: sign octant (3 bits) + dominant axis bit."""
    ax = jnp.abs(d)
    oct_ = (
        (d[:, 0] > 0).astype(jnp.int32) * 4
        + (d[:, 1] > 0).astype(jnp.int32) * 2
        + (d[:, 2] > 0).astype(jnp.int32)
    )
    dom_z = (ax[:, 2] >= jnp.maximum(ax[:, 0], ax[:, 1])).astype(jnp.int32)
    return oct_ * 2 + dom_z


def fine_direction_bin(d: jnp.ndarray, ratio_bits: int = 2) -> jnp.ndarray:
    """8 * 4^ratio_bits cones: sign octant (3 bits) + the two
    |component|/|max| ratios quantized to ratio_bits each. For
    hemispherically divergent (GI) wavefronts the direction interval is
    what blows up a tile's frustum, so cone fineness — not position
    fineness — is the discriminating half of the bin key (measured 3.3x
    on the teapot GI level together with COARSE 8^3 position cells, which
    buy the ray density that makes fine cones fill whole tiles)."""
    ax = jnp.abs(d)
    m = jnp.maximum(jnp.max(ax, axis=1), 1e-9)
    q = 2 ** ratio_bits
    r0 = jnp.clip((ax[:, 0] / m * q).astype(jnp.int32), 0, q - 1)
    r1 = jnp.clip((ax[:, 1] / m * q).astype(jnp.int32), 0, q - 1)
    oct_ = (
        (d[:, 0] > 0).astype(jnp.int32) * 4
        + (d[:, 1] > 0).astype(jnp.int32) * 2
        + (d[:, 2] > 0).astype(jnp.int32)
    )
    return (oct_ << (2 * ratio_bits)) | (r0 << ratio_bits) | r1


def bin_key(o, d, lo, hi, alive=None, pos_bits: int = POS_BITS,
            dir_ratio_bits: int = 0) -> jnp.ndarray:
    """(origin Morton cell << dir bits) | direction cone; dead lanes get a
    key above every live key so they compact to the end.

    Two regimes (measured on the teapot frame):
      shadow rays (near-uniform direction): default fine position cells +
        16 cones — thin beams;
      GI/bounce rays (hemispherical): pos_bits=3, dir_ratio_bits=2 —
        coarse cells for per-bin ray density, 128 fine cones to pin the
        frustum's direction interval (see bounce_bin_key)."""
    if dir_ratio_bits > 0:
        db = fine_direction_bin(d, dir_ratio_bits)
        shift = 3 + 2 * dir_ratio_bits
    else:
        db = direction_bin(d)
        shift = DIR_BITS
    key = (morton3(o, lo, hi, bits=pos_bits) << shift) | db
    if alive is not None:
        key = jnp.where(alive, key, jnp.int32(1) << 30)
    return key


def bounce_bin_key(o, d, lo, hi, alive=None) -> jnp.ndarray:
    """The GI-regime key: 128 fine cones MAJOR x 8^3 position cells minor.

    Direction-major, unlike `bin_key`: with tight batch-origin bounds
    (batch_bounds) the position cells are small, and a position-major key
    makes every fixed-size ray tile span MANY cone groups — its frustum's
    direction interval becomes the union (most of the hemisphere), which
    is exactly what binning exists to prevent. Cone-major keeps each tile
    inside one cone (a cone group is thousands of rays), with the Morton
    cell ordering origins within it."""
    db = fine_direction_bin(d, 2)  # 128 cones
    key = (db << (3 * 3)) | morton3(o, lo, hi, bits=3)
    if alive is not None:
        key = jnp.where(alive, key, jnp.int32(1) << 30)
    return key


@jax.custom_vjp
def _sort_cols(key, *cols):
    """out[j] = cols[.][perm[j]] where perm stable-sorts `key` ascending.
    Returns (sidx, moved_cols); sidx = perm (each sorted slot's original
    index). Linear in `cols` with a data-independent (detached) permutation.

    The custom VJP exists because jax's native sort autodiff linearizes to
    a take_along_axis whose TRANSPOSE is a scatter-add. Moving the
    cotangents back to input order is itself just the inverse
    permutation, which one more variadic lax.sort (keyed on sidx)
    applies."""
    n = key.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    out = jax.lax.sort((key, iota) + cols, num_keys=1)
    return out[1], out[2:]


def _sort_cols_fwd(key, *cols):
    sidx, moved = _sort_cols(key, *cols)
    return (sidx, moved), sidx


def _sort_cols_bwd(sidx, ct):
    _, ct_cols = ct
    # Sorting the cotangents by sidx (a permutation of 0..n-1) lands
    # ct_cols[j] at original slot sidx[j] — the inverse permutation, as
    # one vectorized payload sort instead of n serial scatter-adds.
    moved = jax.lax.sort((sidx,) + tuple(ct_cols), num_keys=1)[1:]
    return (np.zeros(sidx.shape, dtype=jax.dtypes.float0),) + tuple(moved)


_sort_cols.defvjp(_sort_cols_fwd, _sort_cols_bwd)


def bin_sort(key: jnp.ndarray, *payloads):
    """Sort payloads by bin key with ONE variadic lax.sort (all payloads
    move in the same vectorized sorting network — no per-array serial
    gather, forward OR backward: see _sort_cols). Returns
    (sidx, sorted_payloads): `sidx` is each sorted slot's ORIGINAL index;
    pass it to `unsort` to restore original order. Payloads of any dtype;
    [N, k] arrays are split into columns. Gradients flow through float
    payloads; the permutation itself is detached (traversal-decision
    convention, same as the hit ids).

    Boolean payloads ride the sort as int32: XLA's GPU compiler rewrites
    a permutation sort into a scatter whose reduction it then types
    wrongly for pred elements (an HLO verifier failure)."""
    flat, specs = [], []
    for p in payloads:
        q = p.astype(jnp.int32) if p.dtype == jnp.bool_ else p
        if p.ndim == 1:
            flat.append(q)
            specs.append(None)
        else:
            flat.extend(q[:, j] for j in range(p.shape[1]))
            specs.append(p.shape[1])
    sidx, out = _sort_cols(key, *flat)
    rebuilt, k = [], 0
    for p, spec in zip(payloads, specs):
        if spec is None:
            r = out[k]
            k += 1
        else:
            r = jnp.stack(out[k:k + spec], axis=1)
            k += spec
        rebuilt.append(r.astype(jnp.bool_) if p.dtype == jnp.bool_ else r)
    return sidx, tuple(rebuilt)


def unsort(sidx: jnp.ndarray, *payloads):
    """Restore original order: sort payloads by the original indices that
    `bin_sort` returned. Same one-variadic-sort trick."""
    _, rebuilt = bin_sort(sidx, *payloads)
    return rebuilt


def batch_bounds(o: jnp.ndarray, alive: Optional[jnp.ndarray] = None
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Quantization box from the BATCH's own (alive) ray origins — the
    right box for bounce/shadow binning. The scene's box spans every
    object incl. outliers (the reference scene's ±10,000 ground plane,
    main.rs:430-447), so at pos_bits=3 a cell is ~2,500 units and every
    visible-region bounce origin lands in ONE cell: position binning
    degenerates to direction-only and tiles mix origins from the whole
    view. The live origins of one wavefront span only the visible
    surface region (~tens of units here), so quantizing over them makes
    cells surface-patch sized. Dead lanes (garbage o) are excluded; an
    all-dead batch collapses to a point box (constant keys — harmless)."""
    if alive is None:
        return o.min(axis=0), o.max(axis=0)
    big = jnp.float32(3e38)
    m = alive[:, None]
    lo = jnp.where(m, o, big).min(axis=0)
    hi = jnp.where(m, o, -big).max(axis=0)
    ok = lo[0] <= hi[0]
    return jnp.where(ok, lo, 0.0), jnp.where(ok, hi, 0.0)
