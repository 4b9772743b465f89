"""Host-side smoother construction (the reference's `BuildSmoother`).

Re-creates the per-level smoother selection and assembly of
`BaseAMGPC::BuildSmoother` (/root/reference/src/base/precond/amg_pc.cpp:1033+)
for the device smoother set: extracts (pseudo-)inverted diagonal blocks, colors
the graph for multicolor GS, l1-modifies diagonals for provable convergence
(cf. `CalcModDiag`, hybrid_smoother.hpp:43), and estimates the
D^-1 A spectral radius for Chebyshev windows.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..config import SmootherOptions, SmootherType
from ..sparse.host import block_diagonal_fast, block_norm_graph
from .coloring import jones_plassmann_coloring
from .core import ChebyshevSmoother, GSSmoother, JacobiSmoother, Smoother


def plan_row_order(A: sp.spmatrix, bs: int, opts: SmootherOptions, level: int):
    """Color-sorted row permutation for GS levels (None for others).

    Returns (perm, color_bounds): ``perm`` is a block-row permutation such
    that rows sorted by color are contiguous; ``color_bounds`` the (ncol+1,)
    offsets of each color in the permuted ordering.
    """
    kind = SmootherType(opts.type.get(level))
    if kind == SmootherType.DYNBGS:
        # no permutation, but the level must stay in block-ELL (the block
        # sweep gathers matrix rows); () marks that to the device compiler
        return None, ()
    if kind != SmootherType.GS:
        return None, None
    W, _ = block_norm_graph(A, bs)
    colors = jones_plassmann_coloring(W)
    perm = np.argsort(colors, kind="stable")
    counts = np.bincount(colors)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return perm, tuple(int(b) for b in bounds)


def _pinv_blocks(D: np.ndarray) -> np.ndarray:
    """Batched pseudo-inverse of small (bs, bs) diagonal blocks.

    The reference optionally uses pseudo-inverse diagonals in GSS3
    (gssmoother.hpp:18-143) and `CalcPseudoInverseNew`
    (utils_denseLA.hpp:267+) for near-singular elasticity blocks.
    """
    bs = D.shape[-1]
    if bs == 1:
        d = D[:, 0, 0]
        out = np.where(np.abs(d) > 1e-300, 1.0 / np.where(d == 0, 1, d), 0.0)
        return out.reshape(-1, 1, 1)
    return np.linalg.pinv(D, rcond=1e-12)


def _l1_modify(A: sp.spmatrix, bs: int, D: np.ndarray) -> np.ndarray:
    """D + (sum of off-diagonal block norms) * I per row — l1 smoothing."""
    W, _d = block_norm_graph(A, bs)
    offsum = np.asarray(W.sum(axis=1)).ravel()
    Dm = D.copy()
    idx = np.arange(bs)
    Dm[:, idx, idx] += offsum[:, None]
    return Dm


def _cheby_order(opts: SmootherOptions, level: int, bs: int) -> int:
    """Resolve the per-energy Chebyshev order default.

    None = auto: order 3 on scalar levels (fewer matvecs/iter wins on
    Poisson), order 5 on block levels — with the 0.25 window below,
    the configuration that lands 1.25M-DoF 3D elasticity at 38
    iterations at PURE defaults, inside the reference's <40 budget."""
    co = opts.cheby_order.get(level)
    if co is None:
        return 5 if bs > 1 else 3
    return int(co)


def _cheby_lower(opts: SmootherOptions, level: int, bs: int) -> float:
    """Resolve the per-energy Chebyshev window-start default.

    None = auto: 0.30 on scalar levels, 0.25 on block levels (measured
    best window that keeps the mixed-precision residual drift inside
    the strict 1e-8 tolerance — see config.SmootherOptions)."""
    cl = opts.cheby_lower.get(level)
    if cl is None:
        return 0.25 if bs > 1 else 0.30
    return float(cl)


def _lam_max_estimate(A: sp.spmatrix, bs: int, Dinv: np.ndarray, iters=12):
    """Power-iteration estimate of lambda_max(D^-1 A) on the host."""
    n = A.shape[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    lam = 2.0
    from .. import native
    from ..sparse.host import to_bsr

    # native matvec loop (98 scipy matvecs = 13.5 s at 1.25M-DoF
    # elasticity); block levels use the cached BSR view (~bs^2 less
    # index work per matvec)
    An = to_bsr(A, bs) if bs > 1 else A.tocsr()
    nat = native.rho_power(An, Dinv, x, iters)
    if nat is not None:
        return float(nat) * 1.05  # safety margin
    Ac = A.tocsr()
    for _ in range(iters):
        y = Ac @ x
        y = np.einsum("nij,nj->ni", Dinv, y.reshape(-1, bs)).ravel()
        nrm = np.linalg.norm(y)
        if nrm == 0:
            break
        lam = nrm
        x = y / nrm
    return float(lam) * 1.05  # safety margin


def build_smoother(
    A: sp.spmatrix | None,
    bs: int,
    opts: SmootherOptions,
    level: int,
    nrows_pad: int,
    dtype,
    color_bounds: tuple | None = None,
    stencil=None,
    ell: tuple | None = None,
) -> Smoother:
    """Build the device smoother for one (already color-permuted) level.

    ``stencil`` (a transfer/stencil.LatticeOp) replaces ``A`` on structured
    fast-path levels: diagonals, l1 modifications, and the Chebyshev
    lambda_max bound (Gershgorin) all come from the stencil arrays.

    ``ell`` — the level's already-packed ELL arrays ``(data, cols)`` as
    HOST numpy (``data``: (n_pad, K, bs, bs), ``cols``: (n_pad, K),
    left-packed padding like :func:`ngsamg.sparse.host.pad_to_ell`).
    When given, a GS smoother stores its matrix rows SPLIT per color with
    per-color ELL widths (see GSSmoother docstring: the split storage is
    what lets multicolor GS compile at block-problem scale). Omit on
    row-sharded placements, whose uneven per-color arrays cannot be
    partitioned.
    """
    kind = SmootherType(opts.type.get(level))
    steps = int(opts.steps.get(level))
    if stencil is not None:
        if bs != 1:
            raise ValueError("stencil levels are scalar")
        if kind in (SmootherType.JACOBI, SmootherType.CHEBYSHEV):
            # uniform levels: broadcast-scalar Dinv (skips expanding the
            # full diagonal — 80 MB of f64 staging at 10M rows — and all
            # of its transfer/per-sweep HBM traffic)
            cd = stencil.constant_diagonal()
            if cd is not None and cd > 0:
                Dinv1 = np.full((1, 1, 1), 1.0 / cd, dtype=np.dtype(dtype))
                if kind == SmootherType.JACOBI:
                    return JacobiSmoother(
                        Dinv=Dinv1,
                        omega=float(opts.omega.get(level)) * 0.5,
                        steps=max(steps, 1),
                    )
                lam_max = stencil.power_lam()
                lam_min = _cheby_lower(opts, level, bs) * lam_max
                return ChebyshevSmoother(
                    Dinv=Dinv1,
                    lam_max=np.asarray(lam_max, dtype=np.dtype(dtype)),
                    lam_min=np.asarray(lam_min, dtype=np.dtype(dtype)),
                    order=_cheby_order(opts, level, bs),
                    steps=max(steps, 1),
                )
        nv = stencil.n
        D = stencil.diagonal().reshape(-1, 1, 1)
    else:
        nv = A.shape[0] // bs
        D = block_diagonal_fast(A, bs)

    def pad_blocks(B):
        """Numpy staging: the caller ships the whole smoother pytree with
        one device_put."""
        out = np.zeros((nrows_pad, bs, bs), dtype=np.dtype(dtype))
        out[:nv] = B
        return out

    if kind == SmootherType.JACOBI:
        Dinv = _pinv_blocks(D)
        return JacobiSmoother(
            Dinv=pad_blocks(Dinv),
            omega=float(opts.omega.get(level)) * 0.5,
            steps=max(steps, 1),
        )
    if kind == SmootherType.L1_JACOBI:
        if stencil is not None:
            Dm = D.copy()
            Dm[:, 0, 0] += stencil.offdiag_abs_sum()
        else:
            Dm = _l1_modify(A, bs, D)
        Dinv = _pinv_blocks(Dm)
        return JacobiSmoother(
            Dinv=pad_blocks(Dinv),
            omega=float(opts.omega.get(level)),
            steps=max(steps, 1),
        )
    if kind == SmootherType.CHEBYSHEV:
        Dinv = _pinv_blocks(D)
        if stencil is not None:
            lam_max = stencil.power_lam()
        else:
            lam_max = _lam_max_estimate(A, bs, Dinv)
        lam_min = _cheby_lower(opts, level, bs) * lam_max
        return ChebyshevSmoother(
            Dinv=pad_blocks(Dinv),
            lam_max=np.asarray(lam_max, dtype=np.dtype(dtype)),
            lam_min=np.asarray(lam_min, dtype=np.dtype(dtype)),
            order=_cheby_order(opts, level, bs),
            steps=max(steps, 1),
        )
    if kind == SmootherType.DYNBGS:
        from .block import build_dyn_block_gs

        if bs != 1:
            raise ValueError("dyn-block GS operates on scalar matrices")
        return build_dyn_block_gs(
            A, nrows_pad, dtype, steps=max(steps, 1)
        )
    if kind == SmootherType.GS:
        if color_bounds is None or color_bounds == ():
            raise ValueError("GS smoother requires a color-permuted level")
        Dinv = _pinv_blocks(D)
        cdata, ccols, cdinv = (), (), ()
        if ell is not None:
            edata, ecols = ell
            Dinv_t = np.asarray(Dinv, dtype=np.dtype(dtype))
            cd, cc, ci = [], [], []
            for c in range(len(color_bounds) - 1):
                lo, hi = color_bounds[c], color_bounds[c + 1]
                dsl, csl = edata[lo:hi], ecols[lo:hi]
                # per-color ELL width: slots are left-packed, so the last
                # used slot bounds the row degree (a genuinely-zero block
                # at column 0 counts as padding — contributes nothing)
                used = csl != 0
                if dsl.size:
                    used |= (dsl != 0).any(axis=(2, 3))
                if used.size and used.any():
                    w = used.shape[1] - np.argmax(used[:, ::-1], axis=1)
                    w[~used.any(axis=1)] = 0
                    Kc = max(int(w.max()), 1)
                else:
                    Kc = 1
                cd.append(np.ascontiguousarray(
                    dsl[:, :Kc].astype(np.dtype(dtype), copy=False)
                ))
                cc.append(np.ascontiguousarray(csl[:, :Kc]))
                ci.append(Dinv_t[lo:hi].copy())
            cdata, ccols, cdinv = tuple(cd), tuple(cc), tuple(ci)
        return GSSmoother(
            Dinv=pad_blocks(Dinv),
            color_bounds=color_bounds,
            steps=max(steps, 1),
            cdata=cdata,
            ccols=ccols,
            cdinv=cdinv,
        )
    raise ValueError(f"unsupported smoother type {kind}")
