"""Elasticity AMG tests.

Mirrors the reference elasticity suite
(/root/reference/tests/elasticity/mdim/simple/test_3d_lo.py: beam problems,
iteration budget < 40) plus the rigid-body-mode preservation self-check
(`check_kvecs`, elasticity_3d.cpp:682).
"""

import numpy as np
import pytest

from amg_utils import solve_and_check
from ngsamg import AMGOptions
from ngsamg.apps.elasticity import ElasticityEnergy
from ngsamg.utils import fem


def _opts(**kw):
    o = AMGOptions(dtype="float64", **kw)
    o.levels.max_coarse_size = 60
    return o


def test_elast_2d_lo():
    p = fem.elasticity_2d(10, length=10)
    pc, _x, info = solve_and_check(
        p, ms=40, options=_opts(), energy="elasticity"
    )
    assert pc.num_levels >= 3


def test_elast_3d_lo():
    p = fem.elasticity_3d(4, length=10)
    solve_and_check(p, ms=40, options=_opts(), energy="elasticity")


def test_elast_2d_f32_refinement():
    """f32 device path with f64 defect correction still converges."""
    p = fem.elasticity_2d(8, length=8)
    o = AMGOptions()
    o.levels.max_coarse_size = 60
    pc, _x, info = solve_and_check(p, ms=150, options=o, energy="elasticity")
    assert info.outer_iterations >= 2  # refinement actually engaged


def test_elast_eig_bounds():
    p = fem.elasticity_2d(10, length=10)
    pc, _x, _info = solve_and_check(
        p, ms=40, options=_opts(), energy="elasticity"
    )
    lmin, lmax = pc.test(40)
    assert lmax < 1.05 and lmin > 0.02


def test_transport_is_rigid_motion():
    """Q(a->b) composes and reproduces rigid displacements exactly."""
    en = ElasticityEnergy(3)
    rng = np.random.default_rng(0)
    a, b, c = rng.standard_normal((3, 5, 3))
    Qab = en.transport(a, b)
    Qbc = en.transport(b, c)
    Qac = en.transport(a, c)
    np.testing.assert_allclose(
        np.einsum("mij,mjk->mik", Qbc, Qab), Qac, atol=1e-12
    )
    # displacement of the transported coefficient matches u = t + w x (x-a)
    t = rng.standard_normal((5, 3))
    w = rng.standard_normal((5, 3))
    coeff = np.concatenate([t, w], axis=1)
    ub = np.einsum("mij,mj->mi", Qab, coeff)[:, :3]
    np.testing.assert_allclose(
        ub, t + np.cross(w, b - a), atol=1e-12
    )


def test_rbm_preserved_through_hierarchy():
    """check_kvecs analog: rigid-body modes prolongate exactly.

    Interior-only check (near the clamped boundary the vertex weight
    correctly breaks RBM preservation, as in the reference).
    """
    p = fem.elasticity_2d(8, length=6)
    pc = __import__("ngsamg").AMGPreconditioner(
        p.A,
        energy="elasticity",
        block_size=2,
        coords=p.coords,
        options=_opts(),
    ).setup()
    en = pc.energy
    levels = pc.setup_levels_
    assert len(levels) >= 2
    # build a rigid motion's coefficients on the coarsest AMG level
    coarsest = levels[-1]
    pos_c = coarsest.mesh.vertex_data["pos"]
    ref = np.zeros(2)
    rbm = np.array([0.3, -0.2, 0.7])  # (tx, ty, omega)
    coeff = np.einsum(
        "mij,j->mi", en.transport(np.tile(ref, (len(pos_c), 1)), pos_c), rbm
    ).ravel()
    # prolongate down to the finest (FEM, disp-only) level
    v = coeff
    for lev in reversed(levels[:-1]):
        v = lev.P @ v
    # expected displacement field at fine vertices
    pos_f = levels[0].mesh.vertex_data["pos"]
    expect = np.einsum(
        "mij,j->mi",
        en.transport(np.tile(ref, (len(pos_f), 1)), pos_f),
        rbm,
    )[:, :2].ravel()
    # compare away from the clamped boundary (x=0 side)
    interior = np.repeat(pos_f[:, 0] > 1.0, 2)
    err = np.abs(v - expect)[interior]
    assert err.max() < 1e-8, f"max RBM error {err.max():.2e}"


def test_elast_2d_jump():
    """Two-material beam (E jump 1e3) — reference elasticity jump tests
    (tests/elasticity/mdim/jump; budget ms=60). Robust (EVP) matching is
    on by default. kappa(A) ~ 1e9 puts the attainable TRUE-residual floor
    at eps_f64 * kappa ~ 2e-7 — no solver beats that in f64; the reference
    asserts the preconditioned CG error instead (amg_utils.py:361). The
    oracle here: 1e-8 requested, iteration budget held, true residual at
    the floor."""
    import ngsamg

    p = fem.elasticity_2d(10, length=10, jump=True)
    pc = ngsamg.AMGPreconditioner(
        p.A, energy="elasticity", block_size=2, coords=p.coords,
        options=_opts(),
    ).setup()
    x, info = pc.solve(p.b, tol=1e-8, maxiter=60)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.iterations < 60, info.iterations
    assert r < 1e-6, f"true relres {r:.2e} above the f64 kappa floor"


def test_elast_2d_unstructured():
    """Irregular (perturbed Delaunay) elasticity: SPW + robust EVP matching
    + rigid transport off any structured grid."""
    p = fem.unstructured_elasticity(12, dim=2)
    solve_and_check(p, ms=60, options=_opts(), energy="elasticity")


def test_elast_3d_jump():
    p = fem.elasticity_3d(4, length=8, jump=True)
    solve_and_check(p, ms=60, tol=1e-8, options=_opts(), energy="elasticity")


def test_elast_3d_unstructured():
    """Tet-mesh elasticity (6x6 blocks, robust matching off-lattice)."""
    p = fem.unstructured_elasticity(6, dim=3)
    solve_and_check(p, ms=60, options=_opts(), energy="elasticity")


def test_robust_matching_default_and_device_wiring():
    """Elasticity coarsening defaults to robust (EVP) matching, and large
    batches route through the device pencil solver (ops/batched_la)."""
    import ngsamg.apps.elasticity as el

    assert el.ElasticityEnergy(2).default_robust
    p = fem.elasticity_2d(6, length=6)
    en = el.ElasticityEnergy(2)
    mesh = en.build_finest_mesh(p.A, p.coords)
    ref = en.soc_robust(mesh)
    old = el.DEVICE_SOC_MIN_EDGES
    try:
        el.DEVICE_SOC_MIN_EDGES = 1  # force the device (batched_la) path
        dev = en.soc_robust(mesh)
    finally:
        el.DEVICE_SOC_MIN_EDGES = old
    scale = max(float(ref.max()), 1e-30)
    np.testing.assert_allclose(dev / scale, ref / scale, atol=2e-5)


def test_aaf_goal_driven_coarsening():
    """aaf/first_aaf goal factors drive the pairwise rounds."""
    import ngsamg.factory.levels as L
    from ngsamg import AMGPreconditioner
    from ngsamg.config import CoarsenType, SpecOpt

    p = fem.poisson_2d(48)
    o = _opts()
    o.coarsen.algo = SpecOpt(CoarsenType.SPW)  # force algebraic path
    o.coarsen.aaf = SpecOpt(0.1, (0.05,))  # first_aaf aggressive
    pc = AMGPreconditioner(p.A, options=o).setup()
    nvs = pc.log_.nvs
    assert nvs[1] <= 0.06 * nvs[0]  # first level ~20x reduction
    if len(nvs) > 2:
        assert nvs[2] <= 0.12 * nvs[1]


def test_f32_beam_mixed_precision_fallback():
    """Slender-beam f32 hierarchies are beyond the f32 finest matvec's
    attainable accuracy (eps32 ||A|| ||x|| >> ||b||): defect correction
    stagnates and the solver must fall back to the mixed-precision outer
    PCG (f64 Krylov + f32 cycle as M). Measured without the fallback:
    diverges at relres 1.77."""
    p = fem.elasticity_2d(24)
    o = AMGOptions(dtype="float32")
    o.levels.max_coarse_size = 60
    pc, _x, info = solve_and_check(
        p, ms=80, options=o, energy="elasticity"
    )
    assert info.converged
