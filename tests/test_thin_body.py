"""Thin-body (plate) elasticity: the near-singular block-energy regime.

The reference's robust coarsening carries min-eigenvalue pencil SOC with
neighbor-boost accumulation (`AddNeibBoost`, agglomerator_utils.hpp:600-667)
and diagonal stability retention (`diagStabBoost`, spw_agg_impl.hpp:516)
precisely for energies that are near-singular per pair — thin plates/shells
with high-aspect-ratio elements. These tests exercise that regime.
"""

import numpy as np
import pytest

from ngsamg import AMGOptions, AMGPreconditioner, SpecOpt
from ngsamg.apps.elasticity import ElasticityEnergy
from ngsamg.config import CoarsenType, SmootherOptions, SmootherType
from ngsamg.utils import fem


def _plate(n=14, thickness=0.08):
    return fem.thin_plate_elasticity(n=n, thickness=thickness)


def _solve(prob, opts):
    pc = AMGPreconditioner(
        prob.A,
        energy="elasticity",
        block_size=3,
        coords=prob.coords,
        options=opts,
    ).setup()
    x, info = pc.solve(prob.b, tol=1e-8, maxiter=120)
    r = np.linalg.norm(prob.A @ x - prob.b) / np.linalg.norm(prob.b)
    return info, r


def test_neib_boost_degeneracy():
    """Where the strict min-EV SOC degenerates and AddNeibBoost fixes it.

    At the FINEST level both sides collapse together: edge midpoints are
    collinear with the edge, so rank-1 tangential energies stay purely
    translational and C = di(di+dj)^+dj itself drops to rank ~1 — the min
    eigenvalue is finite (and the parallel-sum boost is exactly zero:
    range(E_ik)/\range(E_jk) = {0} for distinct tangents). After ONE round
    of aggregation the aux diagonals pick up rotational rank (varied
    midpoints) while coarse edge energies remain rank-3 sums of parallel
    fine tangents: the bare min eigenvalue on range(C) is then identically
    ~0 for every edge, and only the common-neighbor path accumulation
    (AddNeibBoost, agglomerator_utils.hpp:600-667) makes it usable."""
    from ngsamg.coarsen.pairwise import spw_aggregate_energy
    from ngsamg.mesh.topo import map_edges

    prob = _plate(n=10)
    en = ElasticityEnergy(dim=3)
    mesh = en.build_finest_mesh(prob.A, coords=prob.coords)
    # finest: boost is an exact no-op (trivial range intersections)
    bare0 = en.soc_robust(mesh, reduction="min")
    boost0 = en.soc_robust(mesh, reduction="min", neib_boost=True)
    np.testing.assert_allclose(boost0, bare0, rtol=0, atol=1e-9)
    # one aggregation round -> the degenerate regime
    v2agg, n_agg = spw_aggregate_energy(en, mesh, rounds=1, robust=True)
    ce, e2ce = map_edges(mesh, v2agg, n_agg)
    cmesh = en.map_data(mesh, v2agg, n_agg, ce, e2ce)
    mx = en.soc_robust(cmesh, reduction="max")
    bare = en.soc_robust(cmesh, reduction="min")
    boosted = en.soc_robust(cmesh, reduction="min", neib_boost=True)
    degen = 1e-6 * np.maximum(mx, 1e-300)
    frac_bare_degen = float(np.mean(bare < degen))
    frac_boost_degen = float(np.mean(boosted < degen))
    assert frac_bare_degen > 0.9, frac_bare_degen
    assert frac_boost_degen < 0.1, frac_boost_degen


@pytest.mark.parametrize(
    "strict", [False, True], ids=["default", "strict-min+boost"]
)
def test_thin_plate_converges(strict):
    """Reference-style iteration budget on the thin plate (the elasticity
    suites assert ms=40-100, tests/elasticity/mdim/simple)."""
    prob = _plate(n=14, thickness=0.08)
    opts = AMGOptions()
    opts.coarsen.algo = SpecOpt(CoarsenType.SPW)
    opts.smoother = SmootherOptions(type=SmootherType.CHEBYSHEV)
    opts.levels.max_coarse_size = 200
    if strict:
        opts.coarsen.neib_boost = SpecOpt(True)
        opts.coarsen.soc_reduction = SpecOpt("min")
        opts.coarsen.diag_stab_boost = SpecOpt(0.5)
    info, r = _solve(prob, opts)
    assert info.converged and r < 1e-7, (info.iterations, r)
    assert info.iterations < 100, info.iterations


def test_diag_stab_boost_scalar_path():
    """H1 diagStabBoost composes with the fused native rounds: the
    hierarchy still solves and coarsens more conservatively."""
    prob = fem.unstructured_poisson(40, dim=2)
    base = AMGOptions(dtype="float64")
    base.coarsen.algo = SpecOpt(CoarsenType.SPW)
    boosted = AMGOptions(dtype="float64")
    boosted.coarsen.algo = SpecOpt(CoarsenType.SPW)
    boosted.coarsen.diag_stab_boost = SpecOpt(0.5)
    pc0 = AMGPreconditioner(prob.A, options=base).setup()
    pc1 = AMGPreconditioner(prob.A, options=boosted).setup()
    x, info = pc1.solve(prob.b, tol=1e-8, maxiter=60)
    r = np.linalg.norm(prob.A @ x - prob.b) / np.linalg.norm(prob.b)
    assert info.converged and r < 1e-7, (info.iterations, r)
    # retention makes matching stricter: never coarser than the default
    assert pc1.log_.nvs[1] >= pc0.log_.nvs[1]
