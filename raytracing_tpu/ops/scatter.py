"""Sort-based segment scatter-add: a deterministic `.at[].add`.

A ray-sized scatter-add into a small table has heavy index conflicts
(every ray that hits one triangle adds into the same rows); on a GPU it
runs as atomics whose summation order changes from run to run. The same
reduction as sort + cumsum + segment-boundary differences is all vector
work and sums in a fixed order:

    sort rows by index            (variadic lax.sort — one payload
                                   permutation for all columns)
    cumsum over the sorted rows   (log-depth associative scan)
    per-segment sum = csum[end] - csum[start]   (two TABLE-sized gathers,
                                   thousands of elements, not millions)

Precision note: the cumsum is computed in f32 with a log-depth scan, so a
segment sum carries relative error ~eps * (total / segment) — for gradient
accumulation over millions of contributions this is far below SGD noise
and passes the finite-difference checks at test sizes.

The reference has no analog (its shading is scalar per ray); this is
infrastructure for the differentiable path (SURVEY.md §7 step 6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Below this many rows the serial scatter is cheaper than sort+scan (and
# small sizes are where tests run) — keep the simple path.
_SORT_THRESHOLD = 1 << 15


def segment_scatter_add(n_rows: int, idx: jnp.ndarray,
                        vals: jnp.ndarray) -> jnp.ndarray:
    """Return `zeros((n_rows,) + vals.shape[1:]).at[idx].add(vals,
    mode='drop')`, computed with sort + cumsum + boundary gathers.

    idx: [R] int32, entries in [0, n_rows] — entries == n_rows (or
         beyond) are dropped, matching the dead-lane convention of the
         lazy VJPs.
    vals: [R, K] f32 rows to accumulate.
    """
    r = idx.shape[0]
    if r <= _SORT_THRESHOLD:
        return jnp.zeros((n_rows,) + vals.shape[1:], vals.dtype).at[idx].add(
            vals, mode="drop")
    idx = jnp.minimum(idx.astype(jnp.int32), jnp.int32(n_rows))
    cols = tuple(vals[:, k] for k in range(vals.shape[1]))
    sidx, *scols = jax.lax.sort((idx,) + cols, num_keys=1)
    csum = jnp.cumsum(jnp.stack(scols, axis=1), axis=0)  # [R, K]
    csum0 = jnp.concatenate(
        [jnp.zeros((1, csum.shape[1]), csum.dtype), csum], axis=0)
    targets = jnp.arange(n_rows, dtype=sidx.dtype)
    end = jnp.searchsorted(sidx, targets, side="right")  # [n_rows]
    start = jnp.searchsorted(sidx, targets, side="left")
    return csum0[end] - csum0[start]
