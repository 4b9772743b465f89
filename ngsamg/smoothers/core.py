"""Device-side smoothers: multicolor block-GS, (l1-)Jacobi, Chebyshev.

JAX re-creation of the reference smoother stack
(/root/reference/src/base/smoothers/): the sequential block Gauss-Seidel
`GSS3` (gssmoother.hpp:18-143) becomes a *multicolor* block-GS — rows of one
color update in parallel, colors run sequentially, preserving the
GS character without the sequential row dependency.
`JacobiSmoother`/`RichardsonSmoother` (base_smoother.hpp:251-286) map
directly; the l1-Jacobi variant scales by the l1-modified diagonal
(diag + sum of off-diag block norms), the same provable-convergence device
the reference's `HybridSmoother` uses for its ghost-row modified diagonals
(hybrid_smoother.hpp:10-15 `CalcModDiag`). Chebyshev is the fastest
polynomial smoother (pure SpMV, no sequential structure).

Contract mirrors `BaseSmoother::Smooth/SmoothBack` (base_smoother.hpp:43):
``smooth(sm, A, x, b)`` performs the forward sweep(s), ``smooth_back`` the
reverse; ``x=None`` means a zero initial guess (the reference's ``x_zero``
fast path, which skips the first A@x).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..sparse.bell import BlockELL
from ..sparse.formats import matvec


def _block_mul(Dinv: jax.Array, r: jax.Array) -> jax.Array:
    """(n, bs, bs) x (n, bs) batched block multiply.

    A leading dimension of 1 broadcasts one block over every row — the
    constant-diagonal fast path of uniform stencil levels.
    """
    if Dinv.shape[0] == 1 and r.shape[0] != 1:
        return jnp.einsum(
            "ij,nj->ni", Dinv[0], r, preferred_element_type=Dinv.dtype
        )
    return jnp.einsum(
        "nij,nj->ni", Dinv, r, preferred_element_type=Dinv.dtype
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["Dinv"],
    meta_fields=["omega", "steps"],
)
@dataclass(frozen=True)
class JacobiSmoother:
    """Damped (block-)Jacobi; covers the l1 variant via a modified Dinv."""

    Dinv: jax.Array  # (n_pad, bs, bs)
    omega: float = 1.0
    steps: int = 1


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["Dinv", "cdata", "ccols", "cdinv"],
    meta_fields=["color_bounds", "steps"],
)
@dataclass(frozen=True)
class GSSmoother:
    """Multicolor block Gauss-Seidel on *color-sorted* rows.

    The level's rows are permuted at setup so each color occupies a
    contiguous slice [bounds[c], bounds[c+1]); the sweep is then pure static
    slicing — no gather of matrix rows, no scatter of updates.

    Two storage modes:

    * **split** (``cdata`` non-empty; the single-device production path):
      the matrix rows of every color are stored as SEPARATE per-color
      arrays (``cdata[c]``: (m_c, K_c, bs, bs), ``ccols[c]``: (m_c, K_c),
      ``cdinv[c]``: (m_c, bs, bs)) split at pack time, with per-color ELL
      width K_c. The sweep never slices one big array inside jit — at
      block-problem scale XLA materialized the per-color slices of a
      single (n, K, bs, bs) array as an (ncolors, n, K, bs, bs)
      temporary, which does not fit at 1.25M-DoF 3D elasticity; separate
      input arrays make that impossible, so GS runs at any size like the
      reference's (gssmoother.cpp:196-257).
    * **sliced** (``cdata == ()``; the row-sharded multi-chip path, where
      uneven per-color arrays cannot be partitioned): the sweep slices the
      level's BlockELL ``A.data``/``A.cols`` per color in-graph.
    """

    Dinv: jax.Array  # (n_pad, bs, bs)
    color_bounds: tuple  # (ncolors+1,) static ints, ascending
    steps: int = 1
    cdata: tuple = ()  # per-color (m_c, K_c, bs, bs), or () for sliced mode
    ccols: tuple = ()  # per-color (m_c, K_c) int32
    cdinv: tuple = ()  # per-color (m_c, bs, bs)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["Dinv", "lam_max", "lam_min"],
    meta_fields=["order", "steps"],
)
@dataclass(frozen=True)
class ChebyshevSmoother:
    """Chebyshev polynomial smoother on the D^-1 A spectrum window.

    ``steps`` applies the degree-``order`` polynomial that many times
    (the reference's `sm_steps`, amg_pc.hpp:67; historically this option
    was silently ignored for Chebyshev)."""

    Dinv: jax.Array
    lam_max: jax.Array  # scalar
    lam_min: jax.Array  # scalar
    order: int = 3
    steps: int = 1


Smoother = JacobiSmoother | GSSmoother | ChebyshevSmoother


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def smooth(sm: Smoother, A: BlockELL, x: jax.Array | None, b: jax.Array):
    if isinstance(sm, JacobiSmoother):
        return _jacobi(sm, A, x, b)
    if isinstance(sm, GSSmoother):
        return _gs(sm, A, x, b, reverse=False)
    if isinstance(sm, ChebyshevSmoother):
        return _chebyshev(sm, A, x, b)
    from .hiptmair import HiptmairSmoother, hiptmair_smooth

    if isinstance(sm, HiptmairSmoother):
        return hiptmair_smooth(sm, A, x, b, reverse=False)
    from .block import BlockGSSmoother, block_gs_smooth

    if isinstance(sm, BlockGSSmoother):
        return block_gs_smooth(sm, A, x, b, reverse=False)
    from ..solve.cycle import AMGSmoother

    if isinstance(sm, AMGSmoother):
        return sm.smooth(A, x, b)
    raise TypeError(type(sm))


def smooth_back(sm: Smoother, A: BlockELL, x: jax.Array | None, b: jax.Array):
    if isinstance(sm, GSSmoother):
        return _gs(sm, A, x, b, reverse=True)
    from .hiptmair import HiptmairSmoother, hiptmair_smooth

    if isinstance(sm, HiptmairSmoother):
        return hiptmair_smooth(sm, A, x, b, reverse=True)
    from .block import BlockGSSmoother, block_gs_smooth

    if isinstance(sm, BlockGSSmoother):
        return block_gs_smooth(sm, A, x, b, reverse=True)
    # Jacobi / Chebyshev / AMG-as-smoother are symmetric
    return smooth(sm, A, x, b)


def _jacobi(sm: JacobiSmoother, A, x, b):
    steps = sm.steps
    if x is None:
        x = sm.omega * _block_mul(sm.Dinv, b)
        steps -= 1
    for _ in range(steps):
        r = b - matvec(A, x)
        x = x + sm.omega * _block_mul(sm.Dinv, r)
    return x


def _gs(sm: GSSmoother, A, x, b, *, reverse: bool):
    zero_start = x is None
    if zero_start:
        x = jnp.zeros_like(b)
    bounds = sm.color_bounds
    ncol = len(bounds) - 1
    order = range(ncol - 1, -1, -1) if reverse else range(ncol)
    split = bool(sm.cdata)
    for step in range(sm.steps):
        for ci, c in enumerate(order):
            lo, hi = bounds[c], bounds[c + 1]
            if hi == lo:
                continue
            if zero_start and step == 0 and ci == 0:
                r = b[lo:hi]  # x == 0: skip the row product
            elif split:
                r = b[lo:hi] - jnp.einsum(
                    "mkij,mkj->mi",
                    sm.cdata[c],
                    x[sm.ccols[c]],
                    preferred_element_type=sm.cdata[c].dtype,
                )
            else:
                r = b[lo:hi] - jnp.einsum(
                    "mkij,mkj->mi",
                    A.data[lo:hi],
                    x[A.cols[lo:hi]],
                    preferred_element_type=A.data.dtype,
                )
            Dc = sm.cdinv[c] if split else sm.Dinv[lo:hi]
            upd = _block_mul(Dc, r)
            x = x.at[lo:hi].add(upd)
    return x


def _chebyshev(sm: ChebyshevSmoother, A, x, b):
    """Three-term Chebyshev recurrence on [lam_min, lam_max] (Saad alg. 12.1).

    A polynomial in Dinv A applied to the residual — symmetric, so it serves
    as both forward and backward smoother.
    """
    theta = 0.5 * (sm.lam_max + sm.lam_min)
    delta = 0.5 * (sm.lam_max - sm.lam_min)
    sigma = theta / delta
    for step in range(max(int(getattr(sm, "steps", 1)), 1)):
        rho = 1.0 / sigma
        if x is None:
            r = b
            x = jnp.zeros_like(b)
        else:
            r = b - matvec(A, x)
        d = _block_mul(sm.Dinv, r) / theta
        for _ in range(sm.order - 1):
            x = x + d
            r = r - matvec(A, d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * _block_mul(
                sm.Dinv, r
            )
            rho = rho_new
        x = x + d
    return x
