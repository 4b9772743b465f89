"""Stencil-domain structured setup (transfer/stencil.py) tests.

The fast path must produce exactly the Galerkin operator of the explicit
scipy pipeline (polyphase RAP == P^T A P), pruning must preserve SPD by
construction, and the end-to-end hierarchy must match the generic path's
convergence behavior.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from ngsamg.coarsen.lattice import detect_lattice
from ngsamg.transfer import stencil as st
from ngsamg.transfer.galerkin import rap
from ngsamg.transfer.lattice_transfer import host_lattice_prol
from ngsamg.utils import fem


def _ref_rap(prob, omega):
    idx, dims = detect_lattice(prob.coords)
    cdims = (dims + 1) // 2
    cidx = idx // 2
    key = np.zeros(len(idx), dtype=np.int64)
    for k in range(idx.shape[1]):
        key = key * cdims[k] + cidx[:, k]
    P, _ = host_lattice_prol(
        prob.A, idx, dims, key, int(np.prod(cdims)), omega
    )
    return rap(prob.A, P, dtype=np.float64)


@pytest.mark.parametrize(
    "prob",
    [fem.poisson_2d(17), fem.poisson_2d(16), fem.poisson_3d(9)],
    ids=["2d-odd", "2d-even", "3d-odd"],
)
def test_polyphase_rap_exact(prob):
    _idx, dims = detect_lattice(prob.coords)
    op = st.from_csr(prob.A, dims)
    assert op is not None
    # roundtrip
    d0 = (st.to_csr(op) - prob.A).tocsr()
    d0.eliminate_zeros()
    assert d0.nnz == 0
    omega = 0.55
    opc, _dinv = st.smoothed_rap(op, omega)
    Ac_ref = _ref_rap(prob, omega)
    diff = abs(st.to_csr(opc) - Ac_ref).max()
    assert diff < 1e-12 * abs(Ac_ref).max()


def test_prune_rowsums_and_spd():
    """Pruning preserves row sums exactly; the operator stays SPD."""
    prob = fem.poisson_3d(9)
    _idx, dims = detect_lattice(prob.coords)
    op = st.from_csr(prob.A, dims)
    opc, _ = st.smoothed_rap(op, 0.5)
    pruned = st.prune(opc, 0.05)
    assert len(pruned.offs) < len(opc.offs)
    Ac, Ap = st.to_csr(opc), st.to_csr(pruned)
    np.testing.assert_allclose(
        np.asarray(Ap.sum(axis=1)).ravel(),
        np.asarray(Ac.sum(axis=1)).ravel(),
        rtol=1e-12, atol=1e-14 * abs(Ac).max(),
    )
    evp = np.linalg.eigvalsh(Ap.toarray())
    assert evp.min() > 0


@pytest.mark.parametrize("n", [20, 23, 26, 33])
def test_clamped_hierarchy_exact(n):
    """Uniform-lattice compression must reproduce the uncompressed
    hierarchy bitwise (patch rows run the same scalar op sequences)."""
    prob = fem.poisson_3d(n)
    _idx, dims = detect_lattice(prob.coords)
    A = prob.A if isinstance(prob.A, sp.dia_matrix) else prob.A.tocsr()
    op = (
        st.from_dia(A, dims)
        if isinstance(A, sp.dia_matrix)
        else st.from_csr(A, dims)
    )
    vals = st.detect_uniform(op)
    assert vals is not None
    cop = st.compress_uniform(op.dims, op.offs, vals)
    assert cop.n == op.n
    assert cop.patch.n < op.n  # actually compressed at these sizes
    # level-0 expansion reproduces the operator
    d0 = (st.to_csr(st.expand(cop)) - st.to_csr(op)).tocsr()
    d0.eliminate_zeros()
    assert d0.nnz == 0
    cur_c, cur_f = cop, op
    for _lvl in range(3):
        if cur_f.n <= 128:
            break
        rho_c, rho_f = cur_c.gershgorin(), cur_f.gershgorin()
        assert rho_c == rho_f  # same row-value set
        omega = (4.0 / 3.0) / rho_f
        nxt_c = (
            st.rap_clamped(cur_c, omega, 0.02)
            if isinstance(cur_c, st.ClampedOp)
            else st.prune(st.smoothed_rap(cur_c, omega)[0], 0.02)
        )
        nxt_f = st.prune(st.smoothed_rap(cur_f, omega)[0], 0.02)
        full_c = (
            st.expand(nxt_c) if isinstance(nxt_c, st.ClampedOp) else nxt_c
        )
        diff = (st.to_csr(full_c) - st.to_csr(nxt_f)).tocsr()
        diff.eliminate_zeros()
        assert diff.nnz == 0, f"level diff max {abs(diff).max()}"
        cur_c, cur_f = nxt_c, nxt_f


def test_fast_path_matches_generic_iterations():
    """Stencil hierarchy (prune off) == generic lattice path convergence."""
    from ngsamg import AMGOptions, AMGPreconditioner
    from ngsamg.config import SmootherOptions, SmootherType

    prob = fem.poisson_3d(16)
    iters = {}
    for fast in (True, False):
        opts = AMGOptions(lattice_fast=fast, stencil_prune_tol=0.0)
        opts.smoother = SmootherOptions(type=SmootherType.CHEBYSHEV)
        pc = AMGPreconditioner(
            prob.A, coords=prob.coords, options=opts
        ).setup()
        assert (pc.setup_levels_[0].stencil is not None) == fast
        x, info = pc.solve(prob.b, tol=1e-8)
        r = np.linalg.norm(prob.A @ x - prob.b) / np.linalg.norm(prob.b)
        assert r < 1e-7
        iters[fast] = info.iterations
    # same algorithm up to the lambda_max estimator: a small gap allowed
    assert abs(iters[True] - iters[False]) <= 3, iters


def test_anisotropic_lattice_no_crash():
    """Review finding: rap_clamped must fall back (not crash) when small
    identity dims lose their constant middle at coarse levels."""
    import scipy.sparse as sp2

    from ngsamg import AMGOptions, AMGPreconditioner
    from ngsamg.config import SmootherOptions, SmootherType

    m0, m1 = 4, 12000  # n > 32768 enters the clamped path
    T = lambda k: sp2.diags(
        [-np.ones(k - 1), 2.0 * np.ones(k), -np.ones(k - 1)], [-1, 0, 1]
    )
    A = (sp2.kron(T(m0), sp2.eye(m1)) + sp2.kron(sp2.eye(m0), T(m1))).tocsr()
    X, Y = np.meshgrid(np.arange(m0), np.arange(m1), indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1).astype(float)
    opts = AMGOptions()
    opts.smoother = SmootherOptions(type=SmootherType.CHEBYSHEV)
    pc = AMGPreconditioner(A, coords=coords, options=opts).setup()
    b = np.ones(A.shape[0])
    x, info = pc.solve(b, tol=1e-8, maxiter=120)
    r = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
    assert info.converged and r < 1e-7, (info.iterations, r)


def test_from_csr_sums_duplicates():
    """Review finding: non-canonical CSR duplicates must sum, not
    last-write-win."""
    prob = fem.poisson_2d(9)
    _idx, dims = detect_lattice(prob.coords)
    A = prob.A.tocsr()
    # split one off-diagonal entry into two stored duplicates
    coo = A.tocoo()
    k = int(np.flatnonzero(coo.row != coo.col)[0])
    r, c, v = int(coo.row[k]), int(coo.col[k]), float(coo.data[k])
    rows = np.concatenate([coo.row, [r]])
    cols = np.concatenate([coo.col, [c]])
    data = np.concatenate([coo.data, [0.4 * v]])
    data[k] = 0.6 * v
    Adup = sp.csr_matrix(
        sp.coo_matrix((data, (rows, cols)), shape=A.shape)
    )
    # force duplicate retention: construct CSR directly from COO arrays
    order = np.lexsort((cols, rows))
    indptr = np.zeros(A.shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows[order] + 1, 1)
    Adup = sp.csr_matrix(
        (data[order], cols[order], np.cumsum(indptr)), shape=A.shape
    )
    assert Adup.nnz == A.nnz + 1  # duplicate really stored
    op = st.from_csr(Adup, dims)
    d0 = (st.to_csr(op) - A).tocsr()
    d0.eliminate_zeros()
    assert d0.nnz == 0


def test_fast_path_gating():
    """Jumpy coefficients and GS smoothers must avoid the fast path."""
    from ngsamg import AMGOptions, AMGPreconditioner

    prob = fem.poisson_3d(10, jump=True)
    pc = AMGPreconditioner(prob.A, coords=prob.coords).setup()
    assert pc.setup_levels_[0].stencil is None  # jump -> SPW path
    prob2 = fem.poisson_3d(10)
    pc2 = AMGPreconditioner(prob2.A, coords=prob2.coords).setup()
    # default smoother is GS -> generic path with explicit P
    assert pc2.setup_levels_[0].stencil is None
    x, info = pc2.solve(prob2.b, tol=1e-8)
    assert info.converged


def test_refine_residual_slabbed_matches_plain():
    """Slab-chunked f64 defect-correction residual == whole-lattice path.

    The slabbed variant bounds the emulated-f64 matvec temporaries past
    ~32M rows (the single-chip compile-OOM driver, docs/SCALING.md); it
    must agree with the plain path to f64 roundoff on odd dims, 1-3D,
    with asymmetric offsets and non-divisible slab counts.
    """
    import itertools

    import jax
    import jax.numpy as jnp

    from ngsamg.precond.amg import (
        _refine_residual,
        _refine_residual_slabbed,
    )
    from ngsamg.sparse import formats

    rng = np.random.default_rng(0)
    with jax.enable_x64(True):
        for dims in [(13, 11, 7), (9,), (10, 5)]:
            n = int(np.prod(dims))
            npad = -(-n // 8) * 8
            d = len(dims)
            offs, vals = [], []
            for off in itertools.product(*([(-2, -1, 0, 1)] * d)):
                if sum(abs(o) for o in off) <= 2:
                    offs.append(off)
                    vals.append(float(rng.standard_normal()))
            A64 = formats.StencilDia(
                vals=jnp.asarray(vals, jnp.float64),
                offs=tuple(offs),
                dims=dims,
                nrows=n,
                nrows_pad=npad,
            )
            x = np.zeros((npad, 1))
            x[:n, 0] = rng.standard_normal(n)
            b = np.zeros((npad, 1))
            b[:n, 0] = rng.standard_normal(n)
            x64 = jnp.asarray(x, jnp.float64)
            b64 = jnp.asarray(b, jnp.float64)
            r_ref, rn2_ref = _refine_residual(A64, b64, x64)
            scale = float(jnp.max(jnp.abs(r_ref))) + 1.0
            for nslabs in (2, 3, 5):
                r_s, rn2_s = _refine_residual_slabbed(
                    A64.vals,
                    b64,
                    x64,
                    offs=A64.offs,
                    dims=dims,
                    nslabs=nslabs,
                    nrows=n,
                    nrows_pad=npad,
                )
                err = float(jnp.max(jnp.abs(r_s - r_ref)))
                assert err <= 4e-15 * scale, (dims, nslabs, err)
                assert abs(float(rn2_s - rn2_ref)) <= 1e-12 * max(
                    float(rn2_ref), 1.0
                )
