"""Multigrid operator: V/W/BS cycles over the static level pytree.

JAX re-creation of `AMGMatrix`
(/root/reference/src/base/solve/amg_matrix.hpp:14-128, amg_matrix.cpp:160-345):
`SmoothV` = pre-smooth (zero start) -> restrict residual -> coarse solve ->
prolongate-add -> backward post-smooth; `SmoothW` double-visits coarse
levels; `SmoothBS` cascades V-cycles from successively coarser start levels
(`SmoothVFromLevel`, amg_matrix.cpp:310-345).

Levels have different static shapes, so the cycle is a Python-unrolled
recursion inside jit; every op is a fused gather/matmul kernel on device. The
coarsest level applies a dense (pseudo-)inverse as a single matmul —
replacing the reference's MUMPS/MASTERINVERSE/SparseCholesky coarse solves
(amg_pc.cpp:843-928 `CoarseLevelInv`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..sparse.formats import matvec
from ..smoothers.core import Smoother, smooth, smooth_back
from ..utils.jaxcfg import full_f32


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["A", "smoother", "P", "R"],
    meta_fields=[],
)
@dataclass(frozen=True)
class DeviceLevel:
    """One AMG level on device (the reference's `AMGLevel` capsule)."""

    A: object  # BlockELL | DiaMatrix | SupernodeELL | DenseMatrix
    smoother: Smoother | None
    P: object | None  # prolongation: next-coarser -> this level
    R: object | None  # restriction (P^T stored row-wise by coarse rows)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["levels", "coarse_inv", "cluster_corr"],
    meta_fields=["cycle"],
)
@dataclass(frozen=True)
class AMGOperator:
    """The assembled multigrid preconditioner operator (device pytree)."""

    levels: tuple  # tuple[DeviceLevel, ...]
    coarse_inv: jax.Array | None  # ((nc_pad*bs), (nc_pad*bs)) dense
    cluster_corr: object | None = None  # smoothers.cluster_corr data
    cycle: str = "V"  # V | W | BS

    def __call__(self, b: jax.Array) -> jax.Array:
        return amg_apply(self, b)


def coarse_solve(op: AMGOperator, b: jax.Array) -> jax.Array:
    lev = op.levels[-1]
    if op.coarse_inv is None:
        if lev.smoother is None:
            return jnp.zeros_like(b)
        x = smooth(lev.smoother, lev.A, None, b)
        return smooth_back(lev.smoother, lev.A, x, b)
    n, bs = b.shape
    ci = op.coarse_inv
    if ci.dtype != b.dtype:
        # f64 coarse solve inside an f32 cycle (general/scaled path): an
        # explicit pseudo-inverse with norm ~1/lambda_min applied in f32
        # injects eps32*kappa-sized indefinite noise — measured spectral
        # bounds of the coarsest apply (-1864, 629) where (1, 1) is exact,
        # which makes the whole cycle indefinite and PCG diverge on 3D
        # elasticity. Requires tracing under jax.enable_x64 (the caller
        # scopes it; without x64 the astype canonicalizes back to f32 and
        # this degrades gracefully to the old behavior).
        x = (ci @ b.reshape(-1).astype(ci.dtype)).astype(b.dtype)
    else:
        x = ci @ b.reshape(-1)
    return x.reshape(n, bs)


def _cycle(op: AMGOperator, b: jax.Array, l: int) -> jax.Array:
    levels = op.levels
    if l == len(levels) - 1:
        return coarse_solve(op, b)
    lev = levels[l]
    x = smooth(lev.smoother, lev.A, None, b)
    r = b - matvec(lev.A, x)
    bc = matvec(lev.R, r)
    xc = _cycle(op, bc, l + 1)
    if op.cycle == "W" and l + 1 < len(levels) - 1:
        rc = bc - matvec(levels[l + 1].A, xc)
        xc = xc + _cycle(op, rc, l + 1)
    x = x + matvec(lev.P, xc)
    x = smooth_back(lev.smoother, lev.A, x, b)
    return x


@full_f32
def amg_apply(op: AMGOperator, b: jax.Array) -> jax.Array:
    """One multigrid cycle with zero initial guess (`AMGMatrix::Mult`).

    With a cluster correction attached (near-singular sliver clusters on
    the finest level, see smoothers/cluster_corr.py) the cycle is wrapped
    multiplicatively and symmetrically: C, cycle, C — the analog of the
    reference's dyn-block smoothing for locally defective rows
    (dyn_block_smoother.hpp:16) at two extra finest-level SpMVs.
    """
    core = _bs_cycle if op.cycle == "BS" else partial(_cycle, l=0)
    if op.cluster_corr is None:
        return core(op, b)
    from ..smoothers.cluster_corr import cluster_apply

    A0 = op.levels[0].A
    z = cluster_apply(op.cluster_corr, b)
    z = z + core(op, b - matvec(A0, z))
    return z + cluster_apply(op.cluster_corr, b - matvec(A0, z))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["op"],
    meta_fields=["steps"],
)
@dataclass(frozen=True)
class AMGSmoother:
    """A multigrid operator used as a smoother.

    The reference wraps an `AMGMatrix` tail as a smoother for composed
    solvers (`AMGSmoother`, amg_matrix.hpp:132-158; used by the Stokes
    secondary sequences) — here any AMGOperator becomes a smoother whose
    sweep is `steps` stationary AMG iterations.
    """

    op: AMGOperator
    steps: int = 1

    def smooth(self, A, x, b):
        if x is None:
            x = jnp.zeros_like(b)
        for _ in range(self.steps):
            x = x + amg_apply(self.op, b - matvec(A, x))
        return x


def _cycle_from(op: AMGOperator, b: jax.Array, l: int) -> jax.Array:
    """Full V-cycle rooted at level ``l`` (`SmoothVFromLevel`,
    amg_matrix.cpp:310-374), zero initial guess."""
    return _cycle(op, b, l)


def _bs_cycle(op: AMGOperator, b: jax.Array) -> jax.Array:
    """The reference's BS cascade (`SmoothBS`, amg_matrix.cpp:110-158).

    Descending: each level runs a FULL V-cycle rooted there
    (SmoothVFromLevel), then restricts its updated residual. Coarsest:
    exact solve. Ascending: prolongate the coarse correction and run
    another V-cycle rooted at each level (in correction form — exact for
    linear smoothers with zero-start sweeps).
    """
    levels = op.levels
    L = len(levels)
    if L == 1:
        return coarse_solve(op, b)
    xs, bs_ = [], []
    bl = b
    for l in range(L - 1):
        xl = _cycle_from(op, bl, l)
        rl = bl - matvec(levels[l].A, xl)
        xs.append(xl)
        bs_.append(bl)
        bl = matvec(levels[l].R, rl)
    xc = coarse_solve(op, bl)
    for l in range(L - 2, -1, -1):
        xl = xs[l] + matvec(levels[l].P, xc)
        rl = bs_[l] - matvec(levels[l].A, xl)
        xc = xl + _cycle_from(op, rl, l)
    return xc
