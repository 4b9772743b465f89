"""Unit tests for the framework layers below the preconditioner.

Covers the component inventory of SURVEY.md section 2: sparse formats +
SpMV, host graph utilities, algebraic mesh mapping, coarsening, prolongation
(kernel preservation), Galerkin RAP, smoothers, config system.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from ngsamg import AMGOptions, SpecOpt, options_from_flags
from ngsamg.apps.h1 import H1Energy
from ngsamg.coarsen import pairwise
from ngsamg.coarsen.mis import mis_aggregate
from ngsamg.config import SmootherType
from ngsamg.mesh.topo import AlgebraicMesh, map_edges
from ngsamg.smoothers.coloring import jones_plassmann_coloring
from ngsamg.sparse import bell
from ngsamg.sparse.host import (
    block_diagonal_fast,
    block_norm_graph,
    csr_rowwise_argmax,
    csr_rowwise_max,
    pad_to_ell,
)
from ngsamg.transfer.galerkin import rap
from ngsamg.transfer.prolongation import piecewise_prol, smoothed_prol
from ngsamg.utils import fem


def _rand_spd(n, seed=0, density=0.1):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng)
    A = A + A.T + n * sp.eye(n)
    return A.tocsr()


# ---------------------------------------------------------------------------
# sparse
# ---------------------------------------------------------------------------


def test_bell_spmv_matches_scipy():
    A = _rand_spd(200)
    Ad = bell.from_scipy(A, 1, 1)
    x = np.random.default_rng(1).standard_normal(200)
    xd = bell.block_vec(x, 1, Ad.nrows_pad, Ad.data.dtype)
    y = bell.flat_vec(bell.spmv(Ad, xd), Ad.nrows)
    np.testing.assert_allclose(np.asarray(y), A @ x, rtol=1e-5)


def test_bell_block_spmv():
    p = fem.elasticity_2d(3, length=4)
    Ad = bell.from_scipy(p.A, 2, 2)
    x = np.random.default_rng(2).standard_normal(p.n)
    xd = bell.block_vec(x, 2, Ad.nrows_pad, Ad.data.dtype)
    y = bell.flat_vec(bell.spmv(Ad, xd), Ad.nrows)
    np.testing.assert_allclose(np.asarray(y), p.A @ x, rtol=2e-4, atol=1e-4)


def test_pad_to_ell_roundtrip():
    A = _rand_spd(50)
    data, cols = pad_to_ell(A, 1, 1)
    dense = np.zeros((50, 50))
    for i in range(50):
        for k in range(data.shape[1]):
            dense[i, cols[i, k]] += data[i, k, 0, 0]
    np.testing.assert_allclose(dense, A.toarray(), atol=1e-12)


def test_rowwise_helpers():
    A = sp.csr_matrix(np.array([[0, 2.0, 1.0], [0, 0, 0], [5.0, 0, 3.0]]))
    mx = csr_rowwise_max(A.indptr, A.data)
    np.testing.assert_allclose(mx, [2.0, 0.0, 5.0])
    col, val = csr_rowwise_argmax(A.indptr, A.indices, A.data)
    assert col[0] == 1 and col[2] == 0 and col[1] == -1


def test_block_norm_graph():
    p = fem.elasticity_2d(2, length=3)
    W, d = block_norm_graph(p.A, 2)
    assert W.shape[0] == p.n // 2
    assert (W.data >= 0).all() and (d > 0).all()
    D = block_diagonal_fast(p.A, 2)
    np.testing.assert_allclose(
        D[0], p.A[:2, :2].toarray(), atol=1e-12
    )


# ---------------------------------------------------------------------------
# mesh + coarsening
# ---------------------------------------------------------------------------


def _grid_mesh(n):
    p = fem.poisson_2d(n)
    return H1Energy(1).build_finest_mesh(p.A), p


def test_mesh_from_matrix():
    mesh, p = _grid_mesh(10)
    assert mesh.nv == p.n
    assert (mesh.edges[:, 0] < mesh.edges[:, 1]).all()
    assert (mesh.edge_data["wt"] > 0).all()


def test_map_edges():
    mesh = AlgebraicMesh(
        nv=4, edges=np.array([[0, 1], [1, 2], [2, 3], [0, 2]])
    )
    v2agg = np.array([0, 0, 1, 1])
    ce, e2ce = map_edges(mesh, v2agg, 2)
    assert len(ce) == 1 and tuple(ce[0]) == (0, 1)
    assert e2ce[0] == -1 and e2ce[2] == -1
    assert e2ce[1] == 0 and e2ce[3] == 0


def test_spw_aggregate_ratio():
    mesh, _ = _grid_mesh(24)
    en = H1Energy(1)
    S = mesh.edge_graph(weights=en.soc(mesh))
    v2agg, n_agg = pairwise.spw_aggregate(S, rounds=2, theta=0.05)
    assert (v2agg >= 0).all()
    ratio = mesh.nv / n_agg
    assert 2.5 < ratio < 6.0  # ~4 for 2 pairwise rounds


def test_mis_aggregate():
    mesh, _ = _grid_mesh(24)
    en = H1Energy(1)
    S = mesh.edge_graph(weights=en.soc(mesh))
    v2agg, n_agg = mis_aggregate(S, theta=0.05)
    assert (v2agg >= 0).all()
    assert n_agg < mesh.nv / 2


def test_plate_aggregate():
    coords = np.stack(
        np.meshgrid(np.arange(4.0), np.arange(5.0), indexing="ij"), axis=-1
    ).reshape(-1, 2)
    v2agg, n_agg = pairwise.plate_test_aggregate(coords)
    assert n_agg == 4  # one aggregate per x-column


def test_coloring_valid():
    mesh, p = _grid_mesh(16)
    W, _ = block_norm_graph(p.A, 1)
    colors = jones_plassmann_coloring(W)
    C = W.tocoo()
    assert (colors[C.row] != colors[C.col]).all()


# ---------------------------------------------------------------------------
# transfer
# ---------------------------------------------------------------------------


def test_piecewise_prol_preserves_constants():
    mesh, p = _grid_mesh(16)
    en = H1Energy(1)
    S = mesh.edge_graph(weights=en.soc(mesh))
    v2agg, n_agg = pairwise.spw_aggregate(S)
    ce, e2ce = map_edges(mesh, v2agg, n_agg)
    mesh_c = en.map_data(mesh, v2agg, n_agg, ce, e2ce)
    P = piecewise_prol(en, mesh, mesh_c, v2agg)
    ones = np.ones(n_agg)
    np.testing.assert_allclose(P @ ones, np.ones(mesh.nv), atol=1e-12)


def test_smoothed_prol_preserves_constants_after_truncation():
    mesh, p = _grid_mesh(24)
    en = H1Energy(1)
    # zero L2 weights: pure-Laplacian energy, so the energy kernel is the
    # constants and the prolongation must reproduce them exactly (near
    # Dirichlet boundaries the nonzero vertex weight correctly breaks this)
    mesh.vertex_data["l2wt"][:] = 0.0
    S = mesh.edge_graph(weights=en.soc(mesh))
    v2agg, n_agg = pairwise.spw_aggregate(S)
    ce, e2ce = map_edges(mesh, v2agg, n_agg)
    mesh_c = en.map_data(mesh, v2agg, n_agg, ce, e2ce)
    Ppw = piecewise_prol(en, mesh, mesh_c, v2agg)
    P = smoothed_prol(
        en, mesh, mesh_c, v2agg, Ppw, max_per_row=3, min_frac=0.05
    )
    deg = np.diff(P.tobsr(blocksize=(1, 1)).indptr)
    assert deg.max() <= 3
    np.testing.assert_allclose(
        P @ np.ones(n_agg), np.ones(mesh.nv), atol=1e-10
    )


def test_native_rap_matches_scipy():
    """Fused native Gustavson P^T A P == scipy products (f64 exact)."""
    import ngsamg.native as nat

    if not nat.HAVE_NATIVE:
        import pytest

        pytest.skip("native extension not built")
    import scipy.sparse as sp

    from ngsamg.utils import fem

    p = fem.unstructured_poisson(16, dim=3)
    rng = np.random.default_rng(0)
    nc = p.n // 6
    Pm = sp.coo_matrix(
        (
            rng.standard_normal(p.n),
            (np.arange(p.n), rng.integers(0, nc, p.n)),
        ),
        shape=(p.n, nc),
    ).tocsr()
    C1 = nat.rap_csr(p.A, Pm)
    C2 = (Pm.T @ (p.A @ Pm)).tocsr()
    d = abs(C1 - C2)
    assert (d.max() if d.nnz else 0.0) < 1e-12 * abs(C2).max()
    assert C1.nnz == C2.nnz


def test_rap_matches_dense():
    A = _rand_spd(40)
    P = sp.random(40, 12, density=0.3, random_state=0).tocsr()
    Ac = rap(A, P)
    np.testing.assert_allclose(
        Ac.toarray(), P.T.toarray() @ A.toarray() @ P.toarray(), atol=1e-10
    )


# ---------------------------------------------------------------------------
# smoothers reduce error
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kind", [SmootherType.GS, SmootherType.JACOBI, SmootherType.L1_JACOBI,
             SmootherType.CHEBYSHEV]
)
def test_smoother_reduces_energy_error(kind):
    import jax.numpy as jnp

    from ngsamg.smoothers.build import build_smoother, plan_row_order
    from ngsamg.smoothers.core import smooth, smooth_back
    from ngsamg.config import SmootherOptions

    p = fem.poisson_2d(16)
    opts = SmootherOptions(type=kind)
    A = p.A
    perm, cb = plan_row_order(A, 1, opts, 0)
    if perm is not None:
        A = A[perm][:, perm].tocsr()
    Ad = bell.from_scipy(A, 1, 1)
    sm = build_smoother(A, 1, opts, 0, Ad.nrows_pad, jnp.float32,
                        color_bounds=cb)
    rng = np.random.default_rng(0)
    xex = rng.standard_normal(p.n)
    b = A @ xex
    bd = bell.block_vec(b, 1, Ad.nrows_pad, jnp.float32)
    x = smooth(sm, Ad, None, bd)
    for _ in range(5):
        x = smooth_back(sm, Ad, x, bd)
        x = smooth(sm, Ad, x, bd)
    err0 = np.linalg.norm(xex)
    err = np.linalg.norm(np.asarray(bell.flat_vec(x, Ad.nrows)) - xex)
    assert err < 0.9 * err0


@pytest.mark.parametrize("bs", [1, 3])
def test_gs_split_matches_sliced(bs):
    """Per-color SPLIT GS storage (the single-device production path) is
    bitwise the same sweep as the sliced variant (the row-sharded path) —
    same math, different matrix layout (see GSSmoother docstring)."""
    import jax.numpy as jnp

    from ngsamg.smoothers.build import build_smoother, plan_row_order
    from ngsamg.smoothers.core import smooth, smooth_back
    from ngsamg.config import SmootherOptions

    if bs == 1:
        p = fem.poisson_2d(14)
        A, n = p.A, p.n
    else:
        p = fem.unstructured_elasticity(5, dim=3)
        A, n = p.A, p.n
    opts = SmootherOptions(type=SmootherType.GS, steps=SpecOpt(2))
    perm, cb = plan_row_order(A, bs, opts, 0)
    sperm = (perm[:, None] * bs + np.arange(bs)).ravel()
    A = A[sperm][:, sperm].tocsr()
    Ad = bell.from_scipy(A, bs, bs)
    import numpy as _np

    ell = (_np.asarray(Ad.data), _np.asarray(Ad.cols))
    sm_slice = build_smoother(A, bs, opts, 0, Ad.nrows_pad, jnp.float32,
                              color_bounds=cb)
    sm_split = build_smoother(A, bs, opts, 0, Ad.nrows_pad, jnp.float32,
                              color_bounds=cb, ell=ell)
    assert sm_split.cdata and not sm_slice.cdata
    # per-color widths are trimmed to that color's max row degree
    assert max(d.shape[1] for d in sm_split.cdata) <= Ad.ell_width
    assert sum(d.shape[0] for d in sm_split.cdata) == cb[-1]
    rng = np.random.default_rng(3)
    b = rng.standard_normal(n)
    bd = bell.block_vec(b, bs, Ad.nrows_pad, jnp.float32)
    for x0 in (None, bell.block_vec(rng.standard_normal(n), bs,
                                    Ad.nrows_pad, jnp.float32)):
        xa = smooth(sm_slice, Ad, x0, bd)
        xb = smooth(sm_split, Ad, x0, bd)
        np.testing.assert_allclose(np.asarray(xa), np.asarray(xb),
                                   rtol=1e-6, atol=1e-6)
        ya = smooth_back(sm_slice, Ad, xa, bd)
        yb = smooth_back(sm_split, Ad, xb, bd)
        np.testing.assert_allclose(np.asarray(ya), np.asarray(yb),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_specopt_semantics():
    so = SpecOpt("gs", ["jacobi", "chebyshev"])
    assert so.get(0) == "jacobi"
    assert so.get(1) == "chebyshev"
    assert so.get(2) == "gs"
    assert so.get(99) == "gs"


def test_options_from_flags():
    opts = options_from_flags(
        {
            "ngs_amg_sm_type": "gs",
            "ngs_amg_sm_type_spec": ["jacobi"],
            "ngs_amg_mg_cycle": "W",
            "ngs_amg_max_coarse_size": 100,
            "ngs_amg_theta": 0.1,
        }
    )
    assert opts.smoother.type.get(0) == SmootherType.JACOBI
    assert opts.smoother.type.get(1) == SmootherType.GS
    assert opts.cycle.value == "W"
    assert opts.levels.max_coarse_size == 100
    assert opts.coarsen.theta.get(3) == 0.1


# ---------------------------------------------------------------------------
# element-matrix (ELMAT) energy mode
# ---------------------------------------------------------------------------


def test_elmat_energy_mode():
    from ngsamg import AMGOptions, AMGPreconditioner

    prob, dnums, elmats = fem.poisson_2d_elmats(32)
    pc = AMGPreconditioner(
        prob.A,
        coords=prob.coords,
        options=AMGOptions(),
        elmat_data=(dnums, elmats),
    ).setup()
    x, info = pc.solve(prob.b, tol=1e-8, maxiter=60)
    assert info.converged and info.iterations < 60


def test_elmat_accumulator_matches_matrix_graph():
    """ALG-variant accumulation reproduces the assembled off-diag pattern."""
    from ngsamg.apps.elmat import ElmatAccumulator
    from ngsamg.apps.h1 import H1Energy

    prob, dnums, elmats = fem.poisson_2d_elmats(12)
    acc = ElmatAccumulator(prob.n, variant="alg")
    acc.add_batch(dnums, elmats)
    mesh = acc.finalize(prob.coords)
    ref = H1Energy(1).build_finest_mesh(prob.A, prob.coords)
    assert mesh.ne == ref.ne
    np.testing.assert_array_equal(mesh.edges, ref.edges)


# ---------------------------------------------------------------------------
# block smoothers + batched device LA
# ---------------------------------------------------------------------------


def test_block_gs_reduces_error():
    import ngsamg.api as NgsAMG

    p = fem.poisson_2d(16)
    # blocks = 4x4 patches of the lattice (arbitrary non-overlapping blocks)
    m = 15
    ids = np.arange(p.n).reshape(m, m)
    blocks = [
        ids[i : i + 4, j : j + 4].ravel()
        for i in range(0, m, 4)
        for j in range(0, m, 4)
    ]
    sm = NgsAMG.CreateHybridBlockGSS(p.A, blocks)
    rng = np.random.default_rng(0)
    xex = rng.standard_normal(p.n)
    b = p.A @ xex
    x = np.zeros(p.n)
    eA = lambda v: float((v - xex) @ (p.A @ (v - xex)))
    e_hist = [eA(x)]
    for _ in range(4):
        x = sm.Smooth(x, b)
        x = sm.SmoothBack(x, b)
        e_hist.append(eA(x))
    assert e_hist[-1] < 1e-3 * e_hist[0]
    assert all(b <= a * (1 + 1e-10) for a, b in zip(e_hist, e_hist[1:]))


def test_batched_pencil_matches_numpy():
    from ngsamg.apps.elasticity import _pencil_extreme_eig as np_pencil
    from ngsamg.ops import batched_la as bla

    rng = np.random.default_rng(3)
    X = rng.standard_normal((20, 6, 6))
    # well-conditioned C: rank decisions must agree between the f64 host
    # path and the f32 device path (borderline ranks legitimately differ)
    C = np.einsum("bik,bjk->bij", X, X) + 0.5 * np.eye(6)
    Y = rng.standard_normal((20, 6, 2))
    E = np.einsum("bik,bjk->bij", Y, Y)
    ref = np_pencil(E, C, reduction="max")
    dev = np.asarray(bla.pencil_extreme_eig(E, C, reduction="max"))
    np.testing.assert_allclose(dev, ref, rtol=5e-3, atol=1e-4)


def test_replacement_matrix_spectrally_equivalent():
    """check_aux_mats analog (CheckAuxMatEquivalence,
    vertex_factory_impl.hpp:1701-1741): the replacement matrix A-hat must be
    spectrally comparable to A on generic vectors."""
    p = fem.poisson_2d(24)
    en = H1Energy(1)
    mesh = en.build_finest_mesh(p.A, p.coords)
    Ahat = en.replacement_matrix(mesh).tocsr()
    rng = np.random.default_rng(0)
    ratios = []
    for _ in range(20):
        x = rng.standard_normal(p.n)
        num = x @ (p.A @ x)
        den = x @ (Ahat @ x)
        ratios.append(num / den)
    assert 0.2 < min(ratios) and max(ratios) < 5.0


def test_implicit_lattice_transfer_matches_explicit_P():
    """Device implicit prolongation/restriction must equal the explicit
    scipy P used for the Galerkin product (hierarchy consistency)."""
    import jax.numpy as jnp

    from ngsamg import AMGPreconditioner, AMGOptions
    from ngsamg.config import SmootherOptions, SmootherType
    from ngsamg.sparse.formats import matvec
    from ngsamg.transfer.lattice_transfer import LatticeProlongation

    p = fem.poisson_3d(12)
    opts = AMGOptions()
    opts.smoother = SmootherOptions(type=SmootherType.CHEBYSHEV)
    pc = AMGPreconditioner(p.A, coords=p.coords, options=opts).setup()
    lev = pc.op.levels[0]
    assert isinstance(lev.P, LatticeProlongation)
    # reconstruct the reference explicit P from the transfer metadata
    # (the stencil fast path no longer materializes P on the host)
    from ngsamg.coarsen.lattice import detect_lattice
    from ngsamg.transfer.lattice_transfer import host_lattice_prol

    meta = pc.setup_levels_[0].lattice_transfer
    idx, dims = detect_lattice(p.coords)
    cdims = np.asarray(meta["dims_c"], dtype=np.int64)
    cidx = idx // 2
    key = np.zeros(len(idx), dtype=np.int64)
    for k in range(idx.shape[1]):
        key = key * cdims[k] + cidx[:, k]
    P_explicit, _ = host_lattice_prol(
        p.A, idx, dims, key, int(np.prod(cdims)), meta["omega"]
    )
    nf, nc = P_explicit.shape
    rng = np.random.default_rng(0)
    xc = rng.standard_normal(nc)
    xc_dev = jnp.zeros((lev.P.nc_pad, 1), jnp.float32).at[:nc, 0].set(
        jnp.asarray(xc, jnp.float32)
    )
    yf = np.asarray(matvec(lev.P, xc_dev))[:nf, 0]
    np.testing.assert_allclose(yf, P_explicit @ xc, rtol=1e-4, atol=1e-5)
    # restriction == P^T
    xf = rng.standard_normal(nf)
    xf_dev = jnp.zeros((lev.P.nf_pad, 1), jnp.float32).at[:nf, 0].set(
        jnp.asarray(xf, jnp.float32)
    )
    yc = np.asarray(matvec(lev.R, xf_dev))[:nc, 0]
    np.testing.assert_allclose(yc, P_explicit.T @ xf, rtol=1e-4, atol=1e-5)


def test_dia_sym_half_matvec_matches_full():
    """Half-storage symmetric DIA (XLA path) == full-storage matvec."""
    import jax.numpy as jnp

    from ngsamg.sparse.formats import DiaMatrix, matvec

    rng = np.random.default_rng(3)
    n = 5000
    n_pad = -(-n // 8) * 8
    offs = (0, 1, 70, 500)
    data = np.zeros((2 * len(offs) - 1, n_pad))
    full_offs = tuple(sorted({o for o in offs} | {-o for o in offs}))
    vals = {o: rng.standard_normal(n) for o in offs}
    for o in offs:  # clip: A[i, i+o] exists iff i+o < n
        vals[o][max(n - o, 0):] = 0.0
    for d, o in enumerate(full_offs):
        if o >= 0:
            data[d, :n] = vals[o]
        else:  # data[-o][i] = data[o][i - o] (exact symmetry), 0 for i<o
            data[d, -o:n] = vals[-o][: n + o]
    A_full = DiaMatrix(
        data=jnp.asarray(data, jnp.float32), offsets=full_offs,
        nrows=n, nrows_pad=n_pad,
    )
    half = np.stack([np.pad(vals[o], (0, n_pad - n)) for o in offs])
    A_half = DiaMatrix(
        data=jnp.asarray(half, jnp.float32), offsets=offs,
        nrows=n, nrows_pad=n_pad, sym_half=True,
    )
    x = jnp.asarray(rng.standard_normal((n_pad, 1)), jnp.float32)
    y_full = matvec(A_full, x)
    y_half = matvec(A_half, x)
    np.testing.assert_allclose(
        np.asarray(y_half), np.asarray(y_full), rtol=2e-6, atol=2e-5
    )


def test_dia_from_clamped_sym_halving_end_to_end():
    """A big uniform lattice hierarchy halves its DIA levels and still
    converges identically."""
    from ngsamg import AMGOptions, AMGPreconditioner
    from ngsamg.config import SmootherOptions, SmootherType
    from ngsamg.utils import fem

    import ngsamg.sparse.formats as fmts

    prob = fem.poisson_3d(48)
    opts = AMGOptions()
    opts.smoother = SmootherOptions(type=SmootherType.CHEBYSHEV)
    old = fmts._DIA_SYM_MIN_ROWS
    fmts._DIA_SYM_MIN_ROWS = 10_000  # let the 47^3 level-1 take the path
    try:
        pc = AMGPreconditioner(
            prob.A, coords=prob.coords, options=opts
        ).setup()
    finally:
        fmts._DIA_SYM_MIN_ROWS = old
    from ngsamg.sparse.formats import DiaMatrix

    halved = [
        l.A for l in pc.op.levels
        if isinstance(l.A, DiaMatrix) and l.A.sym_half
    ]
    assert halved, "no level took the symmetric-half storage path"
    assert all(min(A.offsets) == 0 for A in halved)
    x, info = pc.solve(prob.b, tol=1e-8)
    r = np.linalg.norm(prob.A @ x - prob.b) / np.linalg.norm(prob.b)
    assert info.converged and r < 1e-7
    assert info.iterations < 25


def test_cluster_correction_detects_and_fixes_defective_cluster():
    """Near-singular sliver clusters (mixed-sign strong couplings) must be
    detected and solved exactly (smoothers/cluster_corr.py; the reference
    covers this regime with dyn-block smoothers, dyn_block_smoother.hpp:16).
    """
    import scipy.sparse as sp

    from ngsamg.smoothers.cluster_corr import (
        cluster_apply,
        detect_clusters,
    )

    rng = np.random.default_rng(3)
    n = 64
    # 1D Laplacian background
    A = sp.diags(
        [np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.0)],
        [-1, 0, 1],
    ).tolil()
    # implant a 4-vertex near-rank-2 cluster with oscillatory kernel:
    # rows ~ +/- multiples of each other (the measured sliver pattern)
    c = [20, 21, 22, 23]
    B = np.array(
        [
            [1.35, 1.75, -1.17, -1.76],
            [1.75, 2.83, -1.78, -2.67],
            [-1.17, -1.78, 1.32, 1.76],
            [-1.76, -2.67, 1.76, 2.76],
        ]
    ) * 10.0
    B += np.eye(4) * 0.05  # keep SPD overall
    for a, i in enumerate(c):
        for b_, j in enumerate(c):
            A[i, j] = B[a, b_] + (2.0 if i == j else 0.0)
    A = sp.csr_matrix(A)
    ev = np.linalg.eigvalsh(A.toarray())
    assert ev[0] > 0  # SPD
    cc = detect_clusters(A, dtype=np.float64)
    assert cc is not None
    # the implanted cluster is found
    rows = set(np.asarray(cc.idx).ravel().tolist())
    assert set(c) <= rows
    # the stored (padded) inverse is the exact local inverse
    blk = A[c][:, c].toarray()
    k = [
        i for i in range(len(np.asarray(cc.idx)))
        if 20 in np.asarray(cc.idx)[i].tolist()
    ][0]
    iv = np.asarray(cc.inv)[k][: len(c), : len(c)]
    np.testing.assert_allclose(iv @ blk, np.eye(len(c)), atol=1e-12)
    # and the device apply matches the numpy solve (f32 device tolerance)
    import jax
    import jax.numpy as jnp

    r = rng.standard_normal((n, 1))
    z = np.asarray(cluster_apply(
        jax.tree_util.tree_map(jnp.asarray, cc), jnp.asarray(r)
    ))
    zc = np.zeros(n)
    zc[c] = np.linalg.solve(blk, r[c, 0])
    np.testing.assert_allclose(z[:, 0], zc, atol=5e-5)


def test_cluster_correction_no_clusters_on_regular_mesh():
    """Shape-regular meshes have no defective clusters -> zero-cost path."""
    p = fem.poisson_2d(16)
    import scipy.sparse as sp

    from ngsamg.smoothers.cluster_corr import detect_clusters

    assert detect_clusters(sp.csr_matrix(p.A)) is None


def test_cluster_correction_unstructured_iterations():
    """The 3D perturbed-Delaunay problem converges within the reference
    budget WITH the correction; without it the sliver clusters pin
    lambda_min (36 vs 14-16 iterations measured at 104k DoF)."""
    from ngsamg import AMGPreconditioner

    p = fem.unstructured_poisson(20, dim=3)
    o = AMGOptions(dtype="float64")
    pc = AMGPreconditioner(p.A, coords=p.coords, options=o).setup()
    x, info = pc.solve(p.b, tol=1e-8, maxiter=40)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7
    o2 = AMGOptions(dtype="float64")
    o2.cluster_corr.enabled = False
    pc2 = AMGPreconditioner(p.A, coords=p.coords, options=o2).setup()
    x2, info2 = pc2.solve(p.b, tol=1e-8, maxiter=80)
    if pc.op.cluster_corr is not None:
        assert info.iterations <= info2.iterations


def test_elmat_lsq_variant():
    """LSQ weight extraction (CalcAuxWeightsLSQ, amg_pc_vertex.hpp:170-181):
    on P1 Laplace elements the replacement basis fits the element matrix
    EXACTLY, so LSQ weights equal the (negated) off-diagonals, and the
    resulting preconditioner solves within budget."""
    from ngsamg.apps.elmat import ElmatAccumulator

    p, dnums, elmats = fem.poisson_2d_elmats(16)
    nv = p.n
    acc = ElmatAccumulator(nv, variant="lsq")
    acc.add_batch(dnums, elmats)
    mesh = acc.finalize(p.coords)
    # P1 Laplace: E = w1 R_01 + w2 R_02 + w3 R_12 exactly (rowsums 0)
    # -> fitted weight == -E[a,b] summed over elements == assembled -A_ij
    from ngsamg import AMGOptions, AMGPreconditioner

    pc = AMGPreconditioner(
        p.A,
        options=AMGOptions(dtype="float64"),
        elmat_data=(dnums, elmats),
    ).setup()
    x, info = pc.solve(p.b, tol=1e-8, maxiter=30)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7
    A = sp.csr_matrix(p.A).tocoo()
    W = {}
    for i, j, wt in zip(mesh.edges[:, 0], mesh.edges[:, 1],
                        mesh.edge_data["wt"]):
        W[(int(i), int(j))] = wt
    checked = 0
    for i, j, v in zip(A.row, A.col, A.data):
        if i < j and (int(i), int(j)) in W and abs(v) > 1e-12:
            np.testing.assert_allclose(W[(int(i), int(j))], -v, rtol=1e-9)
            checked += 1
    assert checked > 50


# ---------------------------------------------------------------------------
# bucketed/chunked tile-ELL (TileELLStack)
# ---------------------------------------------------------------------------


def _stack_matvec_parity(A, chunk, tile_m=8):
    import jax.numpy as jnp

    from ngsamg.sparse import formats

    st = formats.tile_ell_stack_from_scipy(
        A, np.float32, tile_m=tile_m, chunk=chunk
    )
    assert st is not None
    n, nc = A.shape
    assert st.nrows == n
    assert st.nrows_pad == sum(b.nrows_pad for b in st.blocks)
    assert st.ncols_pad % chunk == 0 and st.ncols_pad >= nc
    x = np.random.default_rng(7).standard_normal(nc).astype(np.float32)
    xp = np.zeros((st.ncols_pad, 1), dtype=np.float32)
    xp[:nc, 0] = x
    y = np.asarray(formats.matvec(st, jnp.asarray(xp)))[: st.nrows, 0]
    np.testing.assert_allclose(y, A @ x, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("chunk", [1, 4])
def test_tile_ell_stack_matvec_matches_scipy(chunk):
    # mesh-like graph: FE Poisson (clustered columns reward chunking)
    p = fem.unstructured_poisson(9, dim=3)
    _stack_matvec_parity(p.A.tocsr().astype(np.float64), chunk)


@pytest.mark.parametrize("n", [257, 1000])  # odd / non-tile-multiple rows
def test_tile_ell_stack_random_odd_sizes(n):
    A = _rand_spd(n, seed=3, density=0.02)
    _stack_matvec_parity(A, 4)


def test_tile_ell_stack_long_tail_buckets():
    # union distribution with a long tail: a few dense rows force K_max
    # far above the mean; bucketing must split (or legally absorb) runs
    n = 4608  # above plan_reorder's dense-level threshold
    rng = np.random.default_rng(5)
    A = sp.random(n, n, density=0.004, random_state=rng).tolil()
    A[:8, ::16] = 1.0  # one very wide tile
    A = (A + A.T + 8 * sp.eye(n)).tocsr()

    from ngsamg.sparse import formats

    perm = formats.plan_reorder(A, 1, 8, tile_sort_chunk=4)
    assert perm is not None
    assert np.array_equal(np.sort(perm), np.arange(n))
    Ap = A[perm][:, perm].tocsr()
    st = formats.tile_ell_stack_from_scipy(Ap, np.float32, chunk=4)
    # tile-sorting puts the wide tile first; the tail splits into a
    # narrower bucket (the 512-tile merge floor bounds how many)
    ks = [b.cols.shape[1] for b in st.blocks]
    assert len(st.blocks) >= 2
    assert min(ks) < max(ks)  # per-bucket widths actually differ
    _stack_matvec_parity(Ap, 4)


def test_tile_ell_stack_in_pipeline():
    # choose_format routes bs==1 non-DIA levels to the stack when a
    # stack_chunk is passed (single-device placements, amg._compile_device)
    from ngsamg.sparse import formats

    p = fem.unstructured_poisson(14, dim=3)
    A = p.A.tocsr()
    perm = formats.plan_reorder(A, 1, 8, tile_sort_chunk=formats.TILE_CHUNK)
    Ap = (A[perm][:, perm]).tocsr() if perm is not None else A
    fmt = formats.choose_format(
        Ap, 1, np.float32, 8, stack_chunk=formats.TILE_CHUNK
    )
    assert isinstance(fmt, (formats.TileELLStack, formats.DiaMatrix))


def test_matvec_slabbed_matches_plain():
    """Row-slab f64 matvec == plain matvec (bitwise per-slab einsums).

    The slab path bounds the transient footprint of an f64 gather+einsum
    whose gathered operand XLA materializes (f64_matvec_slabs sizes the
    slabs from the data bytes). Reference role: all-f64 SpMV of the solve
    phase (utils_sparseLA.hpp SparseMatrix::Mult).
    """
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from ngsamg.sparse import bell, formats

    rng = np.random.default_rng(3)
    with jax.enable_x64(True):
        n = 37
        S = sp.random(n, n, 0.2, random_state=1, format="csr") + sp.eye(n)
        B = sp.kron(S, np.ones((3, 3))).tobsr(blocksize=(3, 3))
        A = bell.from_scipy(B, 3, 3, dtype=np.float64)
        x = jnp.asarray(rng.standard_normal((A.nrows_pad, 3)))
        y0 = np.asarray(formats.matvec(A, x))
        for ns in (2, 5, 64):
            y1 = np.asarray(formats.matvec_slabbed(A, x, ns))
            assert np.array_equal(y0, y1)

        C = (sp.random(400, 400, 0.03, random_state=2, format="csr")
             + sp.eye(400)).tocsr()
        st = formats.tile_ell_stack_from_scipy(C, np.float64)
        if st is not None:
            xp = jnp.asarray(rng.standard_normal((st.ncols_pad, 1)))
            z0 = np.asarray(formats.matvec(st, xp))
            for ns in (3, 16):
                z1 = np.asarray(formats.matvec_slabbed(st, xp, ns))
                assert np.array_equal(z0, z1)

        # heuristic: f32 operators never slab; big f64 ones do
        assert formats.f64_matvec_slabs(A) == 1
        assert formats.f64_matvec_slabs(A, target_bytes=1024) > 1


def test_big_soc_acceptance_check():
    """`checkBigSOC` analog (agglomerator_utils.hpp:394-539): the
    agglomerate-wide stability check vets later-round merges. At the
    matching theta a healthy compact mesh keeps (almost) all matches; at
    an absurd rho every >=3-member union is rejected — the check is live
    and monotone in rho."""
    from ngsamg.apps.elasticity import ElasticityEnergy
    from ngsamg.coarsen.pairwise import (
        big_soc_vet,
        spw_aggregate_energy,
    )

    p = fem.unstructured_elasticity(8, dim=2)
    en = ElasticityEnergy(dim=2)
    mesh = en.build_finest_mesh(p.A, coords=p.coords)

    # one coarsening round, then vet the SECOND round's matches directly
    v2c, n1 = spw_aggregate_energy(en, mesh, rounds=1, theta=0.08,
                                   adopt_orphans=False)
    from ngsamg.mesh.topo import map_edges

    ce, e2ce = map_edges(mesh, v2c, n1)
    cmesh = en.map_data(mesh, v2c, n1, ce, e2ce)
    soc = en.soc_robust(cmesh)
    S = cmesh.edge_graph(weights=soc)
    from ngsamg.coarsen.pairwise import handshake_match

    partner = handshake_match(S, 0.08, can_match=np.ones(n1, bool))
    n_matched = int((partner >= 0).sum())
    assert n_matched > 0
    # tiny rho: everything passes
    vet_lo = big_soc_vet(en, mesh, v2c, partner, rho=1e-12)
    assert (vet_lo == partner).all()
    # absurd rho: every union with >= 3 members must fail the
    # stability bound (pairs of singletons auto-pass, n < 3)
    vet_hi = big_soc_vet(en, mesh, v2c, partner, rho=1e9)
    sizes = np.bincount(v2c[v2c >= 0], minlength=n1)
    a = np.flatnonzero((partner >= 0) & (np.arange(n1) < partner))
    big = (sizes[a] + sizes[partner[a]]) >= 3
    assert big.any()
    assert (vet_hi[a[big]] == -1).all(), "rho=1e9 must reject big unions"
    # acceptance is monotone in rho (stricter rho rejects more). The
    # check is DELIBERATELY strict for rank-1 tangential edge energies:
    # a union whose sub-assembled energy has hinge modes outside the
    # rigid space fails for any positive rho — the reference's own
    # comment on the eps-hack (agglomerator_utils.hpp:512-524)
    # acknowledges exactly this regime, and checkBigSOC is OFF by
    # default there as here.
    vet_sm = big_soc_vet(en, mesh, v2c, partner, rho=1e-3)
    vet_mid = big_soc_vet(en, mesh, v2c, partner, rho=0.08)
    kept_sm = int((vet_sm[a] >= 0).sum())
    kept_mid = int((vet_mid[a] >= 0).sum())
    assert kept_sm >= kept_mid
    assert kept_mid > 0  # 2-member unions always pass (n < 3 early-out)

    # end-to-end: the knob is wired through options, the factory builds
    # a real hierarchy with the vet active, and the solve converges
    from ngsamg import AMGOptions, AMGPreconditioner

    pe = fem.unstructured_elasticity(14, dim=2)
    opts = AMGOptions()
    opts.coarsen.big_soc = SpecOpt(True)
    opts.levels.max_coarse_size = 40
    pc = AMGPreconditioner(
        pe.A, energy="elasticity", block_size=2, coords=pe.coords,
        options=opts,
    ).setup()
    assert pc.num_levels >= 2
    x, info = pc.solve(pe.b, tol=1e-8, maxiter=120)
    r = np.linalg.norm(pe.A @ x - pe.b) / np.linalg.norm(pe.b)
    assert info.converged and r < 1e-7


@pytest.mark.parametrize("bs,C", [(1, 2), (3, 2), (3, 4)])
def test_bell_column_chunked_spmv(bs, C):
    """Column-chunked BlockELL (col_chunk=C): spmv parity with scipy and
    exact to_scipy roundtrip (the knob is off by default — measured
    slower on block energies, docs/SCALING.md — but must stay correct)."""
    if bs == 1:
        p = fem.unstructured_poisson(20, dim=2)
    else:
        p = fem.unstructured_elasticity(6, dim=3)
    A, n = p.A.tocsr(), p.n
    Ad = bell.from_scipy(A, bs, bs, col_chunk=C)
    assert Ad.col_chunk == C
    plain = bell.from_scipy(A, bs, bs)
    assert Ad.data.shape[1] <= plain.data.shape[1]  # fewer slots
    x = np.random.default_rng(0).standard_normal(n)
    xd = bell.block_vec(x, bs, Ad.nrows_pad, Ad.data.dtype)
    y = bell.flat_vec(bell.spmv(Ad, xd), Ad.nrows)
    ref = A @ x
    assert np.abs(np.asarray(y) - ref).max() < 2e-5 * np.abs(ref).max()
    R = bell.to_scipy(Ad)
    assert abs(R - A).max() < 1e-6 * abs(A).max()


def test_native_bsr_mm_matches_scipy():
    """Native block-sparse Gustavson product == scipy scalar product."""
    import ngsamg.native as nat

    if not nat.HAVE_NATIVE:
        pytest.skip("native extension not built")
    p = fem.unstructured_elasticity(7, dim=3)
    A = sp.bsr_matrix(p.A, blocksize=(3, 3))
    rng = np.random.default_rng(0)
    nb = p.n // 3
    nc = max(nb // 4, 1)
    Pb = sp.bsr_matrix(
        (
            rng.standard_normal((nb, 3, 3)),
            rng.integers(0, nc, nb).astype(np.int32),
            np.arange(nb + 1),
        ),
        shape=(p.n, nc * 3),
    )
    C1 = nat.bsr_mm(A, Pb)
    C2 = (A.tocsr() @ Pb.tocsr()).tocsr()
    d = abs(C1.tocsr() - C2)
    assert (d.max() if d.nnz else 0.0) < 1e-12 * abs(C2).max()
    assert C1.tocsr().nnz == C2.nnz


def test_block_rap_matches_scalar():
    """rap(bs_r, bs_c) block route (rectangular 3x6 + square 6x6
    bsr_mm composition) == the scalar kernel."""
    import ngsamg.native as nat

    if not nat.HAVE_NATIVE:
        pytest.skip("native extension not built")
    p = fem.unstructured_elasticity(6, dim=3)
    rng = np.random.default_rng(0)
    nb = p.n // 3
    nc = max(nb // 4, 1)
    Pb = sp.bsr_matrix(
        (
            rng.standard_normal((nb, 3, 6)),
            rng.integers(0, nc, nb).astype(np.int32),
            np.arange(nb + 1),
        ),
        shape=(p.n, nc * 6),
    )
    C1 = rap(p.A, Pb, dtype=np.float64, bs_r=3, bs_c=6)
    C2 = rap(p.A, Pb.tocsr(), dtype=np.float64)
    d = abs(C1 - C2)
    assert (d.max() if d.nnz else 0.0) < 1e-11 * abs(C2).max()
