"""H1 AMG convergence tests.

Mirrors the reference H1 test matrix (/root/reference/tests/h1/simple and
tests/h1/jump; budgets from test_2d_lo.py:12 (<30), jump tests (<30-60),
test_vec.py:54-69 (<30)). Oracle = iteration counts + relative residual, as
in the reference (amg_utils.py:361-362).
"""

import numpy as np
import pytest

from amg_utils import solve_and_check
from ngsamg import AMGOptions, CycleType, SpecOpt
from ngsamg.utils import fem


def test_2d_lo():
    pc, _x, info = solve_and_check(fem.poisson_2d(48), ms=30)
    assert pc.num_levels >= 2
    assert pc.operator_complexity < 2.5


def test_2d_lo_bigger():
    solve_and_check(fem.poisson_2d(96), ms=30)


def test_2d_jump():
    # semi-aux smoothed prol (classic rows use the real matrix) holds jump
    # problems well under the reference's 30-60 budget: measured 18 iters.
    # f64 like the reference's CG — the f32 path pays extra refinement
    # outers on jumpy (kappa ~ 1e4 h^-2) operators and is covered by the
    # f32/bf16 refinement tests
    solve_and_check(
        fem.poisson_2d(64, jump=True), ms=30, options=AMGOptions(dtype="float64")
    )


def test_3d_lo():
    solve_and_check(fem.poisson_3d(12), ms=30)


def test_2d_unstructured():
    """Irregular (perturbed Delaunay) mesh — SPW + smoothed prol +
    supernode formats off-lattice (reference tests use Netgen meshes)."""
    solve_and_check(fem.unstructured_poisson(48, dim=2), ms=30)


def test_3d_unstructured():
    solve_and_check(fem.unstructured_poisson(12, dim=3), ms=30)


def test_2d_unstructured_jump():
    solve_and_check(
        fem.unstructured_poisson(48, dim=2, jump=True), ms=30,
        options=AMGOptions(dtype="float64"),
    )  # measured 16


def test_3d_jump():
    solve_and_check(fem.poisson_3d(14, jump=True), ms=30)  # measured 11


@pytest.mark.parametrize("bs", [2, 3])
def test_vec_h1(bs):
    """Vector-valued (multidim) H1 — identical graph per component."""
    prob = fem.vector_poisson(fem.poisson_2d(32), bs)
    solve_and_check(prob, ms=30)


def test_vec_h1_compound_layout():
    """Component-major (compound FESpace) dof ordering — the reference's
    compound vector-H1 tests (tests/h1/simple/test_vec.py)."""
    import numpy as np
    import scipy.sparse as sp

    from ngsamg import AMGPreconditioner

    base = fem.poisson_2d(24)
    bs, nv = 2, base.n
    # compound layout: A_comp = Perm^T A_inter Perm with external order
    # [x_0..x_n, y_0..y_n]
    prob = fem.vector_poisson(base, bs)
    p = (np.arange(bs)[None, :] * nv + np.arange(nv)[:, None]).ravel()
    inv = np.argsort(p)
    A_comp = prob.A[inv][:, inv].tocsr()
    b_comp = prob.b[inv]
    pc = AMGPreconditioner(
        A_comp, block_size=bs, coords=prob.coords, dof_layout="compound"
    ).setup()
    x, info = pc.solve(b_comp, tol=1e-8, maxiter=30)
    r = np.linalg.norm(A_comp @ x - b_comp) / np.linalg.norm(b_comp)
    assert info.converged and r < 1e-7, (info.iterations, r)


def test_w_cycle():
    opts = AMGOptions(cycle=CycleType.W)
    solve_and_check(fem.poisson_2d(48), ms=30, options=opts)


def test_bs_cycle():
    opts = AMGOptions(cycle=CycleType.BS)
    solve_and_check(fem.poisson_2d(48), ms=30, options=opts)


def test_piecewise_prol():
    """Piecewise-only prolongation converges (more iterations allowed)."""
    opts = AMGOptions()
    opts.prol.type = SpecOpt("piecewise")
    solve_and_check(fem.poisson_2d(48), ms=60, options=opts)


def test_eig_bounds():
    """Spectral self-test (the reference's ngs_amg_do_test)."""
    pc, _x, _info = solve_and_check(fem.poisson_2d(48), ms=30)
    lmin, lmax = pc.test(40)
    assert lmax < 1.05
    assert lmin > 0.05
    assert lmax / max(lmin, 1e-12) < 20.0


def test_amg_as_coarse_component():
    """AMG composed inside an outer two-level method (the reference's BDDC
    test pattern: Preconditioner("bddc", coarsetype="ngs_amg.h1_scal"),
    tests/h1/simple/test_2d_bddc.py) — here: outer additive two-level
    preconditioner whose coarse solve is the AMG operator via AMGSmoother."""
    import numpy as np

    from ngsamg import AMGPreconditioner
    from ngsamg.utils import fem

    p = fem.poisson_2d(48)
    pc = AMGPreconditioner(p.A, coords=p.coords).setup()
    D = p.A.diagonal()

    def outer_prec(r):
        return r / D + pc.apply(r)  # additive Jacobi + AMG composition

    # PCG with the composed preconditioner (host loop, small problem)
    b = p.b
    x = np.zeros_like(b)
    r = b.copy()
    z = outer_prec(r)
    pvec = z.copy()
    rz = r @ z
    it = 0
    for it in range(1, 61):
        q = p.A @ pvec
        alpha = rz / (pvec @ q)
        x += alpha * pvec
        r -= alpha * q
        if np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b):
            break
        z = outer_prec(r)
        rz_new = r @ z
        pvec = z + (rz_new / rz) * pvec
        rz = rz_new
    assert np.linalg.norm(p.A @ x - b) / np.linalg.norm(b) < 1e-7
    assert it < 60


def test_bf16_device_dtype():
    """bfloat16 device compute + f64 defect correction reaches 1e-8."""
    from ngsamg import AMGOptions

    prob = fem.poisson_3d(12)
    solve_and_check(prob, ms=100, options=AMGOptions(dtype="bfloat16"))


@pytest.mark.parametrize("eps", [1e-2, 1e-3])
@pytest.mark.parametrize("angle", [0.0, np.pi / 4])
def test_anisotropic_diffusion(eps, angle):
    """Grid-aligned and rotated anisotropy within the reference budget.

    Justifies keeping `ImproveSProlRow`/`GroupWiseSProl`
    (vertex_factory_impl.hpp:1834-2433) as stand-ins: measured 24-27
    PCG iterations at 128^2 and 256^2 for eps down to 1e-3 in both
    orientations (h-independent), inside the reference's tests' < 30
    budget — the semi-aux prolongation + signed-weight SOC + cluster
    correction already cover the regime on these suites (docs/PARITY.md).
    """
    p = fem.anisotropic_poisson_2d(128, eps=eps, angle=angle)
    # f64 hierarchy: at eps <= 1e-3 the f32 path pays ~10 extra inner
    # iterations to defect-correction noise (row conditioning ~ 1/eps)
    solve_and_check(p, ms=30, options=AMGOptions(dtype="float64"))
