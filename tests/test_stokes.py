"""Stokes (facet-based, divergence-preserving) AMG tests.

The reference ships no in-tree Stokes tests (exercised via examples/,
SURVEY.md section 4); here the oracle is the component's structural
invariants plus convergence budgets on MAC grad-div velocity systems.
"""

import numpy as np

from ngsamg import AMGOptions
from ngsamg.apps import stokes as st
from ngsamg.mesh.topo import map_edges
from ngsamg.precond.stokes import StokesAMG
from ngsamg.utils.stokes_fem import stokes_mac_2d


def _pipeline(n=8, alpha=10.0):
    p = stokes_mac_2d(n, alpha=alpha)
    mesh, interior = st.build_dual_mesh(
        p.cell_pos, p.cell_vol, p.facet_cells, p.facet_flow
    )
    v2agg, n_agg = st.coarsen_cells(mesh)
    ce, e2ce = map_edges(mesh, v2agg, n_agg)
    cmesh = st.map_stokes_mesh(mesh, v2agg, n_agg, ce, e2ce)
    P = st.flow_prolongation(mesh, cmesh, v2agg, e2ce)
    return p, mesh, cmesh, v2agg, e2ce, P


def test_loops_span_kernel():
    """Curl matrix columns lie in ker(D) and span it completely."""
    p = stokes_mac_2d(8)
    mesh, _ = st.build_dual_mesh(
        p.cell_pos, p.cell_vol, p.facet_cells, p.facet_flow
    )
    C = st.build_loops(mesh)
    assert np.abs(p.D @ C).max() == 0.0
    ker_dim = p.n - (np.linalg.matrix_rank(p.D.toarray()))
    assert np.linalg.matrix_rank(C.toarray()) == ker_dim


def test_prolongation_preserves_divergence_free():
    p, mesh, cmesh, v2agg, e2ce, P = _pipeline()
    Cc = st.build_loops(cmesh)
    rng = np.random.default_rng(0)
    U = Cc @ rng.standard_normal(Cc.shape[1])
    div = p.D @ (P @ U)
    assert np.abs(div).max() < 1e-12


def test_prolongation_preserves_flux():
    """Total fine flux through every coarse facet equals its coarse flux
    (velocity-unit dofs: flux_e = flow_e * u_e, coarse flux = flow_c * U)."""
    p, mesh, cmesh, v2agg, e2ce, P = _pipeline()
    rng = np.random.default_rng(1)
    U = rng.standard_normal(cmesh.ne)
    u = P @ U
    sgn = np.where(
        v2agg[mesh.edges[:, 0]] == cmesh.edges[np.maximum(e2ce, 0), 0],
        1.0,
        -1.0,
    )
    tot = np.zeros(cmesh.ne)
    m = e2ce >= 0
    np.add.at(tot, e2ce[m], (sgn * mesh.edge_data["flow"] * u)[m])
    np.testing.assert_allclose(
        tot, cmesh.edge_data["flow"] * U, atol=1e-12
    )


def test_prolongation_div_exact_varying_flows():
    """D_f P = Frac D_c holds EXACTLY on simplicial meshes (varying facet
    areas) — the flux-coordinate conjugation of flow_prolongation; the
    incidence-unit construction alone is exact only for constant flows."""
    from ngsamg.utils.stokes_fem import stokes_tri

    p, _n = stokes_tri(10, dim=2)
    mesh, _ = st.build_dual_mesh(
        p.cell_pos, p.cell_vol, p.facet_cells, p.facet_flow
    )
    v2agg, n_agg = st.coarsen_cells(mesh)
    ce, e2ce = map_edges(mesh, v2agg, n_agg)
    cmesh = st.map_stokes_mesh(mesh, v2agg, n_agg, ce, e2ce)
    P = st.flow_prolongation(mesh, cmesh, v2agg, e2ce)
    Cc = st.build_loops(cmesh)
    rng = np.random.default_rng(3)
    U = Cc @ rng.standard_normal(Cc.shape[1])  # coarse div-free
    div = p.D @ (P @ U)
    assert np.abs(div).max() < 1e-10, np.abs(div).max()


def test_stokes_solve():
    p = stokes_mac_2d(24, alpha=10.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 100
    pc = StokesAMG(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        options=opts,
    ).setup()
    x, info = pc.solve(p.b, tol=1e-8, maxiter=150)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7
    assert info.iterations < 120
    assert pc.num_levels >= 3


def test_tree_loops_span_kernel_off_lattice():
    """Spanning-forest loops span ker(D) on a perturbed (non-lattice)
    dual mesh — the general-mesh CalcFacetLoops replacement."""
    p = stokes_mac_2d(8)
    rng = np.random.default_rng(5)
    pos = p.cell_pos + rng.uniform(-0.2, 0.2, p.cell_pos.shape) / 8
    mesh, _ = st.build_dual_mesh(
        pos, p.cell_vol, p.facet_cells, p.facet_flow
    )
    from ngsamg.coarsen.lattice import detect_lattice

    assert detect_lattice(mesh.vertex_data["pos"]) is None
    C = st.build_loops(mesh)
    assert C is not None
    assert np.abs(p.D @ C).max() == 0.0
    ker_dim = p.n - np.linalg.matrix_rank(p.D.toarray())
    assert np.linalg.matrix_rank(C.toarray()) == ker_dim


def test_stokes_off_lattice_hiptmair_every_level():
    """Perturbed-mesh Stokes converges with Hiptmair on EVERY smoothed
    level (VERDICT r1 #7: loops must survive off-lattice + coarsening)."""
    from ngsamg.smoothers.hiptmair import HiptmairSmoother

    p = stokes_mac_2d(16, alpha=10.0)
    rng = np.random.default_rng(7)
    pos = p.cell_pos + rng.uniform(-0.25, 0.25, p.cell_pos.shape) / 16
    opts = AMGOptions()
    opts.levels.max_coarse_size = 60
    pc = StokesAMG(
        p.A,
        cell_pos=pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        options=opts,
    ).setup()
    assert pc.num_levels >= 3
    for lev in pc.op.levels[:-1]:
        assert isinstance(lev.smoother, HiptmairSmoother), (
            "Hiptmair must survive off-lattice coarsening"
        )
    x, info = pc.solve(p.b, tol=1e-8, maxiter=200)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7, (info.iterations, r)


def test_stokes_solve_stiff_penalty():
    p = stokes_mac_2d(16, alpha=1000.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 60
    pc = StokesAMG(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        options=opts,
    ).setup()
    x, info = pc.solve(p.b, tol=1e-8, maxiter=200)
    assert info.converged


def test_stokes_alpha_robustness():
    """Curl-space prolongation smoothing removes the grad-div penalty's
    alpha-dependence (measured 28/39/54/63 -> 23/23/27/32 over
    alpha = 1..1e3 before/after)."""
    iters = {}
    for alpha in (1.0, 1000.0):
        p = stokes_mac_2d(24, alpha=alpha)
        o = AMGOptions()
        o.levels.max_coarse_size = 100
        pc = StokesAMG(
            p.A,
            cell_pos=p.cell_pos,
            cell_vol=p.cell_vol,
            facet_cells=p.facet_cells,
            facet_flow=p.facet_flow,
            options=o,
        ).setup()
        x, info = pc.solve(p.b, tol=1e-8, maxiter=120)
        assert info.converged
        iters[alpha] = info.iterations
    assert iters[1000.0] < 45, iters
    assert iters[1000.0] <= 2 * iters[1.0], iters


def test_stokes_3d():
    from ngsamg.utils.stokes_fem import stokes_mac_3d

    p = stokes_mac_3d(8, alpha=10.0)
    mesh, _ = st.build_dual_mesh(
        p.cell_pos, p.cell_vol, p.facet_cells, p.facet_flow
    )
    C = st.build_loops(mesh)
    assert np.abs(p.D @ C).max() == 0.0
    opts = AMGOptions()
    opts.levels.max_coarse_size = 150
    pc = StokesAMG(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        options=opts,
    ).setup()
    x, info = pc.solve(p.b, tol=1e-8, maxiter=200)
    assert info.converged and info.iterations < 120


def test_stokes_simplicial_2d():
    """Facet-flux Stokes on a REAL unstructured triangle mesh: facet areas
    vary, the dual graph is irregular — exercises flow-scaled loops, SPW
    cell coarsening and the geometric divergence end to end (the
    reference's simplicial NC/HDiv facet spaces, src/stokes/)."""
    from ngsamg.utils.stokes_fem import stokes_tri

    p, normals = stokes_tri(16, dim=2, alpha=10.0)
    mesh, _ = st.build_dual_mesh(
        p.cell_pos, p.cell_vol, p.facet_cells, p.facet_flow
    )
    C = st.build_loops(mesh)
    assert np.abs(p.D @ C).max() < 1e-12  # flow-weighted kernel
    opts = AMGOptions()
    opts.levels.max_coarse_size = 80
    pc = StokesAMG(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        options=opts,
    ).setup()
    assert pc.num_levels >= 3
    x, info = pc.solve(p.b, tol=1e-8, maxiter=150)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7, (info.iterations, r)
    assert info.iterations < 40, info.iterations


def test_stokes_simplicial_3d():
    """Tet-mesh facet-flux Stokes (3D unstructured)."""
    from ngsamg.utils.stokes_fem import stokes_tri

    p, normals = stokes_tri(6, dim=3, alpha=10.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 150
    pc = StokesAMG(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        options=opts,
    ).setup()
    x, info = pc.solve(p.b, tol=1e-8, maxiter=200)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7, (info.iterations, r)
    assert info.iterations < 60, info.iterations


def test_cr_vector_stokes_invariants():
    """Crouzeix-Raviart (NC P1) VECTOR facet dofs: the real NC
    discretization of the reference's stokes_gg_* (src/stokes/ncfes/).
    Invariants: vector loop basis spans ker(D) exactly; constant velocity
    fields prolongate exactly away from the no-slip boundary; div-free
    coarse fields prolongate div-free."""
    from ngsamg.utils.stokes_fem import stokes_cr

    dim = 2
    p, normals = stokes_cr(10, dim=dim, alpha=10.0)
    mesh, _ = st.build_dual_mesh(
        p.cell_pos, p.cell_vol, p.facet_cells, p.facet_flow
    )
    C = st.build_loops_vec(mesh)
    assert np.abs(p.D @ C).max() < 1e-12
    v2agg, n_agg = st.coarsen_cells(mesh)
    ce, e2ce = map_edges(mesh, v2agg, n_agg)
    cmesh = st.map_stokes_mesh(mesh, v2agg, n_agg, ce, e2ce)
    P = st.flow_prolongation_vec(mesh, cmesh, v2agg, e2ce)
    # constants exact away from aggregates touching the no-slip boundary
    # (there the constant violates the eliminated BC — unreachable for
    # any div-preserving P)
    ncell = len(p.cell_vol)
    cnt = np.bincount(p.facet_cells.ravel(), minlength=ncell)
    agg_bnd = np.zeros(n_agg, dtype=bool)
    np.maximum.at(agg_bnd, v2agg, cnt < dim + 1)
    fac_ok = ~(
        agg_bnd[v2agg[mesh.edges[:, 0]]] | agg_bnd[v2agg[mesh.edges[:, 1]]]
    )
    sel = np.repeat(fac_ok, dim)
    for k in range(dim):
        U = np.zeros(cmesh.ne * dim)
        U[k::dim] = 1.0
        u = P @ U
        err = np.abs((u - np.tile(np.eye(dim)[k], mesh.ne))[sel]).max()
        assert err < 1e-10, err
    Cc = st.build_loops_vec(cmesh)
    rng = np.random.default_rng(0)
    U = Cc @ rng.standard_normal(Cc.shape[1])
    assert np.abs(p.D @ (P @ U)).max() < 1e-10


def test_cr_vector_stokes_solve():
    """CR vector Stokes AMG converges, alpha-robustly (the tangential
    columns of the vector pot space: 324 -> ~60 iters at alpha=1e3)."""
    import ngsamg.api as NgsAMG
    from ngsamg.utils.stokes_fem import stokes_cr

    iters = {}
    for alpha in (10.0, 1000.0):
        p, _ = stokes_cr(16, dim=2, alpha=alpha)
        opts = AMGOptions()
        opts.levels.max_coarse_size = 150
        pc = NgsAMG.stokes_gg_2d(
            p.A,
            cell_pos=p.cell_pos,
            cell_vol=p.cell_vol,
            facet_cells=p.facet_cells,
            facet_flow=p.facet_flow,  # (nf, 2): vector dofs auto-detected
            options=opts,
        )
        assert pc.GetNLevels() >= 3
        x, info = pc.solve(p.b, tol=1e-8, maxiter=250)
        r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
        assert info.converged and r < 1e-7, (alpha, info.iterations, r)
        iters[alpha] = info.iterations
    assert iters[10.0] < 40, iters
    assert iters[1000.0] < 100, iters


def test_cr_vector_stokes_3d():
    from ngsamg.precond.stokes import StokesAMG
    from ngsamg.utils.stokes_fem import stokes_cr

    p, _ = stokes_cr(5, dim=3, alpha=10.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 300
    opts.smoother.cheby_order = 8
    pc = StokesAMG(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        options=opts,
    ).setup()
    x, info = pc.solve(p.b, tol=1e-8, maxiter=300)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7, (info.iterations, r)


def test_hdiv_stokes_simplicial():
    """HDiv-variant AMG (variable dofs + preserved vectors) on a real
    triangle mesh: normal/tangential facet frames from the geometry."""
    import ngsamg.api as NgsAMG
    from ngsamg.utils.stokes_fem import stokes_tri_hdiv

    p, counts, V = stokes_tri_hdiv(14, alpha=10.0)
    assert counts.min() == 1 and counts.max() == 2  # variable dof counts
    opts = AMGOptions()
    opts.levels.max_coarse_size = 120
    pc = NgsAMG.stokes_hdiv_gg_2d(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        facet_dof_counts=counts,
        preserved=V,
        options=opts,
    )
    assert pc.GetNLevels() >= 3
    x, info = pc.solve(p.b, tol=1e-8, maxiter=300)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7, (info.iterations, r)


def test_hdiv_stokes_simplicial_3d():
    """Tet-mesh HDiv variant: variable counts (1 or 3 dofs/facet),
    preserved constants in geometric normal/tangent frames
    (stokes_hdiv_gg_3d export)."""
    import ngsamg.api as NgsAMG
    from ngsamg.utils.stokes_fem import stokes_tri_hdiv

    p, counts, V = stokes_tri_hdiv(5, dim=3, alpha=10.0)
    assert counts.min() == 1 and counts.max() == 3
    opts = AMGOptions()
    opts.levels.max_coarse_size = 250
    pc = NgsAMG.stokes_hdiv_gg_3d(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        facet_dof_counts=counts,
        preserved=V,
        options=opts,
    )
    x, info = pc.solve(p.b, tol=1e-8, maxiter=400)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7, (info.iterations, r)


def test_hdg_embedded_stokes():
    """Static-condensed P1-HDG facet system through the aux embedding:
    the reference's HDiv-HDG + secondary-sequence pattern
    (hdiv_hdg_embedding.hpp) with a REAL higher-order facet FE source."""
    import ngsamg.api as NgsAMG
    from ngsamg.utils.stokes_fem import stokes_hdg_p1

    S, b, E, geo = stokes_hdg_p1(12, alpha=10.0)
    # E: constant aux vector -> equal nodal traces
    nf = E.shape[1] // 2
    U = np.zeros(nf * 2)
    U[0::2] = 3.0
    U[1::2] = -2.0
    assert np.allclose((E @ U).reshape(nf, 2, 2), np.array([3.0, -2.0]))
    opts = AMGOptions()
    opts.levels.max_coarse_size = 150
    pc = NgsAMG.stokes_hdg_gg_2d(S, E, **geo, options=opts)
    assert pc.GetNLevels() >= 3
    x, info = pc.solve(b, tol=1e-8, maxiter=200)
    r = np.linalg.norm(S @ x - b) / np.linalg.norm(b)
    assert info.converged and r < 1e-7, (info.iterations, r)
    assert info.iterations < 40, info.iterations


def test_hdg_embedded_stokes_3d():
    """Tet-mesh condensed P1-HDG (9 dofs/facet) through the embedding."""
    import ngsamg.api as NgsAMG
    from ngsamg.utils.stokes_fem import stokes_hdg_p1

    S, b, E, geo = stokes_hdg_p1(5, alpha=10.0, dim=3)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 300
    pc = NgsAMG.stokes_hdg_gg_3d(S, E, **geo, options=opts)
    x, info = pc.solve(b, tol=1e-8, maxiter=300)
    r = np.linalg.norm(S @ x - b) / np.linalg.norm(b)
    assert info.converged and r < 1e-7, (info.iterations, r)
    assert info.iterations < 40, info.iterations


def test_hdiv_preserved_vectors_exact():
    """Preserved vectors stay exactly representable: P @ V_c == V_f
    (preserved_vectors.hpp computeCoarseBasis semantics)."""
    from ngsamg.apps.stokes_hdiv import (
        MeshDOFs,
        PreservedVectors,
        preserved_prolongation,
    )
    from ngsamg.mesh.topo import map_edges
    from ngsamg.utils.stokes_fem import stokes_mac_2d_hdiv

    p, counts, V = stokes_mac_2d_hdiv(12)
    mesh, _ = st.build_dual_mesh(
        p.cell_pos, p.cell_vol, p.facet_cells, p.facet_flow
    )
    dofs = MeshDOFs.from_counts(counts)
    pres = PreservedVectors(n_special=1, vectors=V)
    v2agg, n_agg = st.coarsen_cells(mesh)
    ce, e2ce = map_edges(mesh, v2agg, n_agg)
    cmesh = st.map_stokes_mesh(mesh, v2agg, n_agg, ce, e2ce)
    P_flux = st.flow_prolongation(mesh, cmesh, v2agg, e2ce)
    P, dofs_c, pres_c = preserved_prolongation(
        mesh, cmesh, v2agg, e2ce, dofs, pres, P_flux
    )
    assert P.shape == (dofs.ndof, dofs_c.ndof)
    # variable coarse counts: flux-only facets vs flux+preserved blocks
    assert dofs_c.counts().min() >= 1
    assert dofs_c.counts().max() >= 2
    E = np.abs(P @ pres_c.vectors - V)
    # Exact preservation everywhere a div-preserving prolongation CAN
    # deliver it: all higher (tangential) dofs, all cross-facet fluxes,
    # and interior fluxes of divergence-balanced aggregates. Aggregates
    # touching the no-slip boundary see the constant fields violate the
    # eliminated BC (their div-inconsistent component is unreachable for
    # ANY div-preserving P); the deviation is confined there and O(h).
    h = 1.0 / 12
    cellpos = mesh.vertex_data["pos"]
    bnd_cell = (cellpos.min(axis=1) < 1.1 * h) | (
        cellpos.max(axis=1) > 1 - 1.1 * h
    )
    agg_bnd = np.zeros(n_agg, dtype=bool)
    np.maximum.at(agg_bnd, v2agg, bnd_cell)
    fac = np.searchsorted(dofs.offsets, np.arange(dofs.ndof), "right") - 1
    excusable = (
        (e2ce[fac] < 0)
        & agg_bnd[v2agg[mesh.edges[fac, 0]]]
        & np.isin(np.arange(dofs.ndof), dofs.offsets[:-1])
    )
    assert E[~excusable].max() < 1e-10, E[~excusable].max()
    assert E.max() < 2 * h  # boundary deviation stays O(h)
    # divergence preservation survives: dof-0 columns carry the flows
    Cc = st.build_loops(cmesh)
    rng = np.random.default_rng(0)
    Uc = np.zeros(dofs_c.ndof)
    Uc[dofs_c.offsets[:-1]] = Cc @ rng.standard_normal(Cc.shape[1])
    div = p.D @ (P @ Uc)
    assert np.abs(div).max() < 1e-10


def test_hdiv_stokes_solve():
    """HDiv-variant AMG converges on the variable-dof facet system."""
    import ngsamg.api as NgsAMG
    from ngsamg.utils.stokes_fem import stokes_mac_2d_hdiv

    p, counts, V = stokes_mac_2d_hdiv(16, alpha=10.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 120
    pc = NgsAMG.stokes_hdiv_gg_2d(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        facet_dof_counts=counts,
        preserved=V,
        options=opts,
    )
    assert pc.GetNLevels() >= 2
    x, info = pc.solve(p.b, tol=1e-8, maxiter=200)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7, (info.iterations, r)


def test_stokes_api_export():
    import ngsamg.api as NgsAMG
    from ngsamg.utils.stokes_fem import stokes_mac_2d

    p = stokes_mac_2d(16, alpha=10.0)
    pc = NgsAMG.stokes_gg_2d(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        ngs_amg_max_coarse_size=80,
    )
    assert pc.GetNLevels() >= 2
    x, info = pc.solve(p.b, tol=1e-8, maxiter=150)
    assert info.converged


def test_loops_with_zero_flow_facets_span_kernel():
    """Facets whose oriented flow sums cancelled to zero must become
    standalone kernel columns — a cycle routed through one loses its
    flux (latent until coarse 3D levels produced such facets)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    # small dual mesh with one zero-flow edge on a cycle
    edges = np.array([[0, 1], [1, 2], [2, 3], [0, 3], [1, 3]])
    mesh = st.AlgebraicMesh(nv=4, edges=edges)
    mesh.vertex_data["pos"] = rng.standard_normal((4, 2))
    mesh.vertex_data["vol"] = np.ones(4)
    flow = np.array([1.0, 2.0, 0.0, 1.5, -0.7])
    mesh.edge_data["flow"] = flow
    C = st.build_loops_tree(mesh)
    D = sp.coo_matrix(
        (
            np.concatenate([flow, -flow]),
            (
                np.concatenate([edges[:, 0], edges[:, 1]]),
                np.concatenate([np.arange(5)] * 2),
            ),
        ),
        shape=(4, 5),
    ).tocsr()
    assert np.abs(D @ C).max() < 1e-14
    want = 5 - np.linalg.matrix_rank(D.toarray())
    assert np.linalg.matrix_rank(C.toarray()) == C.shape[1] == want

    # vector variant: a zero flow VECTOR must yield dim basis columns
    mesh.edge_data["flow"] = np.stack(
        [flow, rng.standard_normal(5) * (flow != 0)], axis=1
    )
    Cv = st.build_loops_vec(mesh)
    fl = mesh.edge_data["flow"]
    dofs = (np.arange(5)[:, None] * 2 + np.arange(2)).ravel()
    Dv = sp.coo_matrix(
        (
            np.concatenate([fl.ravel(), -fl.ravel()]),
            (
                np.concatenate(
                    [np.repeat(edges[:, 0], 2), np.repeat(edges[:, 1], 2)]
                ),
                np.concatenate([dofs, dofs]),
            ),
        ),
        shape=(4, 10),
    ).tocsr()
    assert np.abs(Dv @ Cv).max() < 1e-14
    wantv = 10 - np.linalg.matrix_rank(Dv.toarray())
    assert np.linalg.matrix_rank(Cv.toarray()) == Cv.shape[1] == wantv
