"""Host-side graph coloring for parallel Gauss-Seidel sweeps.

The reference runs shared-memory block-GS with graph-colored block partitions
(/root/reference/src/base/smoothers/block_gssmoother.hpp:30-37
`block_colors`). On the device the colored sweep *is* the Gauss-Seidel
parallelization: rows of one color update concurrently (vectorized), colors
run sequentially — the same dependency-breaking idea, minus threads.

Coloring uses vectorized Jones-Plassmann rounds (random priorities; every
round, uncolored vertices that are local maxima among their uncolored
neighbors take the round's color), O(nnz) numpy work per color.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def jones_plassmann_coloring(
    W: sp.csr_matrix, max_colors: int = 63, seed: int = 0
) -> np.ndarray:
    """Distance-1 coloring of a symmetric graph; returns (n,) color ids.

    Speculative parallel greedy: every uncolored vertex tentatively takes
    the smallest color absent from its *colored* neighborhood (computed for
    all vertices at once with a uint64 bitmask + reduceat); conflicts on an
    edge are resolved by random priority. Converges in a handful of O(nnz)
    rounds and uses at most maxdeg+1 colors — both matter, since the color
    count is the sequential depth of the device GS sweep.
    """
    n = W.shape[0]
    indptr, indices = W.indptr, W.indices
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    from ..native import greedy_color as _native_color

    nat = _native_color(indptr, indices)
    if nat is not None:
        return np.asarray(nat)
    rng = np.random.default_rng(seed)
    prio = rng.random(n)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    colors = np.full(n, -1, dtype=np.int64)
    nonempty = np.flatnonzero(np.diff(indptr) > 0)
    for _round in range(200):
        uncolored = colors < 0
        if not uncolored.any():
            break
        # bitmask of colors used by (already colored) neighbors
        nb_col = colors[indices]
        bits = np.where(
            nb_col >= 0, np.uint64(1) << nb_col.clip(0).astype(np.uint64), 0
        ).astype(np.uint64)
        used = np.zeros(n, dtype=np.uint64)
        if len(nonempty):
            used[nonempty] = np.bitwise_or.reduceat(bits, indptr[nonempty])
        # smallest unset bit = count of trailing ones
        inv = ~used
        low = inv & (~inv + np.uint64(1))  # lowest set bit of inv
        cand = np.log2(low.astype(np.float64)).astype(np.int64)
        cand = np.where(uncolored, cand, colors)
        # conflict detection: adjacent uncolored pair with equal tentative
        # color -> lower priority retries next round
        ci, cj = cand[rows], cand[indices]
        both_unc = uncolored[rows] & uncolored[indices]
        clash = both_unc & (ci == cj) & (prio[rows] < prio[indices])
        loser = np.zeros(n, dtype=bool)
        loser[rows[clash]] = True
        accept = uncolored & ~loser
        colors[accept] = cand[accept]
    if (colors < 0).any():
        raise RuntimeError("coloring did not converge")
    if colors.max() >= max_colors:
        raise RuntimeError(f"coloring used {colors.max()+1} > {max_colors}")
    return colors.astype(np.int32)


def color_row_lists(colors: np.ndarray, pad_row: int, align: int = 8):
    """Per-color row index arrays, padded (with ``pad_row``) to ``align``.

    ``pad_row`` must point to an all-zero padded matrix row so that padded
    entries are no-ops in the sweep.
    """
    ncol = int(colors.max()) + 1 if len(colors) else 0
    out = []
    for c in range(ncol):
        rows = np.flatnonzero(colors == c).astype(np.int32)
        npad = -(-len(rows) // align) * align - len(rows)
        if npad:
            rows = np.concatenate(
                [rows, np.full(npad, pad_row, dtype=np.int32)]
            )
        out.append(rows)
    return out
