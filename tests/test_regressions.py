"""Regression tests for round-2 correctness fixes (ADVICE.md items).

Each test pins a bug found by review: permuted coarsest-level inverse,
explicit-zero-block edge alignment (elasticity), nested SpecOpt from
``*_spec``-only flags, dropped-vertex edge mapping, native handshake
eligibility, and the SPW aggregate-size cap.
"""

import numpy as np
import scipy.sparse as sp

from ngsamg import AMGOptions, AMGPreconditioner
from ngsamg.utils import fem


def test_solve_return_device_matches_host():
    """return_device=True: the device f64 solution equals the host-return
    path bitwise and its device-computed relres is the true residual."""
    import jax

    p = fem.poisson_3d(12)
    pc = AMGPreconditioner(
        p.A, coords=p.coords, options=AMGOptions()
    ).setup()
    xd, info = pc.solve(p.b, tol=1e-8, return_device=True)
    x = np.asarray(jax.device_get(xd))
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert r < 1e-7
    assert abs(info.relres - r) <= 0.5 * r  # device relres is the true one
    xh, _ = pc.solve(p.b, tol=1e-8)
    np.testing.assert_array_equal(x, xh)


def test_coarsest_perm_inverse():
    """ADVICE high: single-level INV solve on an unstructured (RCM-permuted)
    coarsest level must invert the matrix in the device row order."""
    prob = fem.unstructured_poisson(75, dim=2)
    assert prob.n > 4096  # large enough to trigger supernode reorder
    opts = AMGOptions()
    opts.levels.max_levels = 1
    pc = AMGPreconditioner(prob.A, coords=prob.coords, options=opts).setup()
    r = prob.b / np.linalg.norm(prob.b)
    x = pc.apply(r)
    x_ref = sp.linalg.spsolve(prob.A.tocsc(), r)
    err = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    assert err < 1e-4, f"coarsest inverse in wrong basis: rel err {err:.3e}"


def test_elasticity_explicit_zero_block():
    """ADVICE medium: explicitly-stored zero off-diagonal blocks must not
    shift the edge/block alignment in build_finest_mesh."""
    from ngsamg.apps.elasticity import ElasticityEnergy

    prob = fem.elasticity_2d(n=3, length=3)
    en = ElasticityEnergy(dim=2)
    mesh_ref = en.build_finest_mesh(prob.A, prob.coords)

    # store an explicit zero 2x2 block at a structurally-new off-diag slot
    A = prob.A.tolil()
    nv = prob.A.shape[0] // 2
    # find a vertex pair (0, j) NOT currently coupled
    B = prob.A.tobsr(blocksize=(2, 2))
    coupled = set(B.indices[B.indptr[0] : B.indptr[1]])
    j = next(v for v in range(2, nv) if v not in coupled)
    for a in range(2):
        for c in range(2):
            A[a, 2 * j + c] = 0.0
            A[2 * j + c, a] = 0.0
    A = A.tocsr()  # keeps explicit zeros
    en2 = ElasticityEnergy(dim=2)
    mesh2 = en2.build_finest_mesh(A, prob.coords)

    assert mesh2.ne == mesh_ref.ne
    np.testing.assert_array_equal(mesh2.edges, mesh_ref.edges)
    np.testing.assert_allclose(
        mesh2.edge_data["mat"], mesh_ref.edge_data["mat"], rtol=1e-12
    )


def test_spec_only_flag():
    """ADVICE medium: a ``*_spec``-only flag must not nest SpecOpt."""
    from ngsamg.config import (
        SmootherType,
        SpecOpt,
        options_from_flags,
    )

    opts = options_from_flags({"ngs_amg_sm_type_spec": ["jacobi"]})
    v0 = opts.smoother.type.get(0)
    v1 = opts.smoother.type.get(1)
    assert not isinstance(v0, SpecOpt)
    assert not isinstance(v1, SpecOpt)
    assert SmootherType(v0) == SmootherType.JACOBI
    assert SmootherType(v1) == SmootherType.GS
    # and an actual setup must not raise
    prob = fem.poisson_2d(16)
    AMGPreconditioner(
        prob.A, coords=prob.coords, ngs_amg_sm_type_spec=["jacobi"]
    ).setup()


def test_map_edges_dropped_vertex():
    """ADVICE low: edges touching dropped vertices (v2agg == -1) collapse
    instead of producing negative coarse indices."""
    from ngsamg.mesh.topo import AlgebraicMesh, map_edges

    mesh = AlgebraicMesh(
        nv=4, edges=np.array([[0, 1], [1, 2], [2, 3]], dtype=np.int64)
    )
    v2agg = np.array([0, -1, 1, 1], dtype=np.int64)  # vertex 1 dropped
    coarse_edges, e2ce = map_edges(mesh, v2agg, 2)
    assert (coarse_edges >= 0).all()
    assert len(coarse_edges) == 0  # only edges via the dropped vertex cross
    assert (e2ce == -1).all()


def test_handshake_eligibility_mask():
    """VERDICT weak #6: the native handshake path must respect can_match."""
    from ngsamg.coarsen.pairwise import handshake_match

    rng = np.random.default_rng(3)
    n = 60
    G = sp.random(n, n, density=0.15, random_state=3, format="csr")
    S = G + G.T
    S.setdiag(0)
    S.eliminate_zeros()
    S.data = np.abs(S.data) + 0.1
    can = np.ones(n, dtype=bool)
    blocked = rng.choice(n, size=20, replace=False)
    can[blocked] = False
    partner = handshake_match(S.tocsr(), theta=0.0, can_match=can)
    assert (partner[blocked] == -1).all()
    matched = partner >= 0
    assert matched.any()
    # matched partners must be mutual and both eligible
    m = np.flatnonzero(matched)
    assert (partner[partner[m]] == m).all()
    assert can[m].all()


def test_spw_max_agg_cap():
    """ADVICE low: max_agg bounds aggregate sizes."""
    from ngsamg.coarsen.pairwise import spw_aggregate

    prob = fem.poisson_2d(24)
    S = sp.csr_matrix(prob.A)
    S.setdiag(0)
    S.eliminate_zeros()
    S.data = np.abs(S.data)
    v2agg, n_agg = spw_aggregate(S, rounds=6, max_agg=4, adopt_orphans=False)
    sizes = np.bincount(v2agg[v2agg >= 0], minlength=n_agg)
    assert sizes.max() <= 4
    assert n_agg < S.shape[0] / 2  # still actually coarsens


def test_mixed_device_pcg_paths():
    """The device-resident mixed-precision outer PCG (f64 Krylov + f32
    cycle as M, solve/pcg.pcg_mixed) must build an f64 device twin of the
    finest operator for every format family and converge to the f64
    tolerance the f32 inner PCG cannot reach on its own."""
    from ngsamg.config import SmootherOptions, SmootherType
    from ngsamg.sparse import formats

    # BlockELL (GS-colored elasticity finest, scaled+permuted)
    p = fem.elasticity_3d(8)
    pc = AMGPreconditioner(
        p.A, energy="elasticity", block_size=3, coords=p.coords
    ).setup()
    x, info = pc.solve(p.b, tol=1e-8, mixed=True)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7
    assert pc._A64_mixed is not None

    # DiaMatrix finest (Chebyshev, no row permutation)
    opts = AMGOptions()
    opts.smoother = SmootherOptions(type=SmootherType("chebyshev"))
    up = fem.unstructured_poisson(12, dim=3)
    pc = AMGPreconditioner(up.A, coords=up.coords, options=opts).setup()
    x, info = pc.solve(up.b, tol=1e-8, mixed=True)
    r = np.linalg.norm(up.A @ x - up.b) / np.linalg.norm(up.b)
    assert info.converged and r < 1e-7

    # TileELLStack finest: force the tile path by disallowing DIA
    import ngsamg.sparse.formats as fm

    old = fm.count_diagonals
    fm.count_diagonals = lambda A, limit=None: 10**9
    try:
        up2 = fem.unstructured_poisson(20, dim=3)
        pc = AMGPreconditioner(
            up2.A, coords=up2.coords, options=opts
        ).setup()
        assert isinstance(
            pc.A_dev, (fm.TileELLStack, fm.TileELL, fm.SupernodeELL)
        ), type(pc.A_dev)
        x, info = pc.solve(up2.b, tol=1e-8, mixed=True)
        r = np.linalg.norm(up2.A @ x - up2.b) / np.linalg.norm(up2.b)
        assert info.converged and r < 1e-7
        assert type(pc._A64_mixed) is type(pc.A_dev)
    finally:
        fm.count_diagonals = old
