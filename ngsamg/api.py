"""Reference-compatible API surface (the `NgsAMG` module analog).

The reference exports preconditioner classes `h1_scal / h1_2d / h1_3d /
elast_2d / elast_3d / stokes_*` plus visualization/introspection methods
through `ExportAMGClass` (/root/reference/src/base/python/python_amg.hpp:
12-105, python_amg.cpp:37-63) and standalone smoother constructors
(`CreateHybridGSS` etc., python_smoothers.cpp:144-391). This module provides
the same names and method surface over the strict-algebraic-mode core so a
reference user can port scripts:

    import ngsamg.api as NgsAMG
    pc = NgsAMG.h1_scal(A, ngs_amg_max_coarse_size=500)
    pc.GetNLevels(), pc.GetNDof(1), pc.GetBF(level=2, dof=7)

Construction takes a scipy sparse matrix (this framework hosts no FE
library; the reference's `AMGSolverSettings`/`AMGRegister` strict mode,
amg_register.hpp:24-100, is the matching entry point there).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .config import AMGOptions, SmootherType, options_from_flags
from .precond.amg import AMGPreconditioner
from .sparse import bell


class _AMGClass(AMGPreconditioner):
    """AMGPreconditioner + the reference's introspection methods."""

    _energy = "h1"
    _block_size = 1

    def __init__(self, A=None, coords=None, freedofs=None, **flags):
        if A is None:
            # the reference's two-phase lifecycle (amg_pc.cpp:375-420):
            # construct first, InitLevel(freedofs) captures the free-DOF
            # set, FinalizeLevel(mat) receives the assembled matrix and
            # builds
            self._pending = {
                "coords": coords, "freedofs": freedofs, "flags": flags,
            }
            return
        self._pending = None
        super().__init__(
            A,
            energy=self._energy,
            block_size=self._block_size,
            coords=coords,
            freedofs=freedofs,
            **flags,
        )
        self.setup()

    # -- lifecycle (BaseAMGPC::InitLevel/FinalizeLevel, amg_pc.cpp) -----
    def InitLevel(self, freedofs=None):
        """Capture the free-DOF set before the matrix arrives
        (`BaseAMGPC::InitLevel`, amg_pc.cpp:375)."""
        if getattr(self, "_pending", None) is None:
            raise RuntimeError(
                "InitLevel: construct with A=None for the two-phase "
                "lifecycle"
            )
        self._pending["freedofs"] = freedofs

    def FinalizeLevel(self, mat):
        """Receive the assembled matrix and build the AMG hierarchy
        (`BaseAMGPC::FinalizeLevel` -> `Finalize` -> `BuildAMGMat`,
        amg_pc.cpp:420-565)."""
        p = getattr(self, "_pending", None)
        if p is None:
            raise RuntimeError("FinalizeLevel: already finalized")
        self._pending = None
        AMGPreconditioner.__init__(
            self,
            mat,
            energy=self._energy,
            block_size=self._block_size,
            coords=p["coords"],
            freedofs=p["freedofs"],
            **p["flags"],
        )
        self.setup()

    def RegularizeMatrix(self, mat, block_size: int | None = None):
        """Kernel-stabilize near-singular diagonal blocks (`RegTM` /
        `RegularizeMatrix`, elasticity_pc_impl.hpp:139)."""
        return RegularizeMatrix(
            mat, block_size or self._block_size
        )

    # -- introspection (python_amg.hpp:30-105) --------------------------
    def GetNLevels(self, rank: int = 0) -> int:
        return self.num_levels

    def GetNProcs(self, level: int = 0) -> int:
        return 1  # single-host; device count is a mesh property

    def GetBlockSize(self, level: int = 0) -> int:
        return self.setup_levels_[level].row_bs

    def GetNDof(self, level: int = 0, rank: int = 0) -> int:
        lev = self.setup_levels_[level]
        return lev.A.shape[0]

    def GetNDBS(self, level: int = 0, rank: int = 0):
        return self.GetNDof(level), self.GetBlockSize(level)

    def GetBF(self, level: int = 0, dof: int = 0, comp: int = 0, rank=0):
        """Coarse basis function: e_dof on `level` prolongated to finest.

        (`AMGMatrix::GetBF`, amg_matrix.hpp; used by drawBF.py.)
        """
        lev = self.setup_levels_[level]
        v = np.zeros(lev.A.shape[0])
        bs = lev.row_bs
        v[dof * bs + comp if bs > 1 else dof] = 1.0
        for li in range(level - 1, -1, -1):
            v = self.setup_levels_[li].P @ v
        return v

    def CINV(self, rhs: np.ndarray) -> np.ndarray:
        """Apply the coarse(st)-level inverse to a coarsest-level vector."""
        lev = self.setup_levels_[-1]
        Ad = lev.A.toarray()
        return np.linalg.pinv(Ad, rcond=1e-12, hermitian=True) @ rhs

    def GetSmoother(self, level: int = 0):
        return self.op.levels[level].smoother

    def GetAMGMatrix(self):
        return self.op

    def GetMap(self) -> "DOFMap":
        """The DOF map: transfer steps with TransferF2C/TransferC2F
        (reference `DOFMap`/`BaseDOFMapStep` py-exports,
        src/base/coarsening/python_coarse.cpp:15,58)."""
        return DOFMap(
            [
                TransferStep(lev.P)
                for lev in self.setup_levels_
                if lev.P is not None
            ]
        )

    def GetOC(self) -> float:
        return self.operator_complexity

    def Mult(self, b: np.ndarray) -> np.ndarray:
        return self.apply(b)

    def Test(self):
        lmin, lmax = self.test()
        print(f"eigenvalues of M^-1 A in [{lmin:.4g}, {lmax:.4g}]")
        return lmin, lmax


class h1_scal(_AMGClass):
    """Scalar H1 AMG (reference export `h1_scal`, python_h1.cpp:24-47)."""

    _energy = "h1"
    _block_size = 1


class h1_2d(_AMGClass):
    """2-component vector H1 ("multidim") AMG."""

    _block_size = 2

    def __init__(self, A, **kw):
        from .apps.h1 import H1Energy

        kw.setdefault("energy", H1Energy(bs=2))
        AMGPreconditioner.__init__(self, A, block_size=2, **kw)
        self.setup()


class h1_3d(_AMGClass):
    """3-component vector H1 AMG."""

    _block_size = 3

    def __init__(self, A, **kw):
        from .apps.h1 import H1Energy

        kw.setdefault("energy", H1Energy(bs=3))
        AMGPreconditioner.__init__(self, A, block_size=3, **kw)
        self.setup()


class _ElastAMGClass(_AMGClass):
    def GetRotationOfBF(self, level: int = 1, dof: int = 0, comp: int = 0):
        """Rotational components of a coarse basis function.

        The reference exposes this through the MultiDofMapStep secondary
        map (python_elasticity.cpp:24-45): prolongate e_dof down to the
        finest AMG (disp+rot) level using the PRE-embedding prolongation
        and return the rotation coefficients per vertex."""
        lev = self.setup_levels_[level]
        v = np.zeros(lev.A.shape[0])
        v[dof * lev.row_bs + comp] = 1.0
        for li in range(level - 1, 0, -1):
            v = self.setup_levels_[li].P @ v
        P0 = self.setup_levels_[0].P_amg
        if P0 is None:
            raise RuntimeError("finest level has no AMG-space prolongation")
        if level >= 1:
            v = P0 @ v
        dpv = self.energy.dpv
        dim = self.energy.dim
        return v.reshape(-1, dpv)[:, dim:]


class elast_2d(_ElastAMGClass):
    """2D elasticity AMG (3 DOFs/vertex AMG space)."""

    _energy = "elasticity"
    _block_size = 2

    def __init__(self, A, coords, **flags):
        super().__init__(A, coords=coords, **flags)


class elast_3d(_ElastAMGClass):
    """3D elasticity AMG (6 DOFs/vertex AMG space)."""

    _energy = "elasticity"
    _block_size = 3

    def __init__(self, A, coords, **flags):
        super().__init__(A, coords=coords, **flags)


class _StokesAMGClass:
    """Stokes facet AMG with the reference export surface."""

    def __init__(self, A, *, cell_pos, cell_vol, facet_cells, facet_flow,
                 facet_verts=None, vert_pos=None, bnd_facet_verts=None,
                 options=None, **flags):
        from .precond.stokes import StokesAMG

        if options is None:
            options = options_from_flags(flags) if flags else AMGOptions()
        self._pc = StokesAMG(
            A,
            cell_pos=cell_pos,
            cell_vol=cell_vol,
            facet_cells=facet_cells,
            facet_flow=facet_flow,
            facet_verts=facet_verts,
            vert_pos=vert_pos,
            bnd_facet_verts=bnd_facet_verts,
            options=options,
        ).setup()

    def GetNLevels(self, rank: int = 0):
        return self._pc.num_levels

    def GetNDof(self, level: int = 0, rank: int = 0):
        return self._pc.setup_levels_[level].A.shape[0]

    def GetAMGMatrix(self):
        return self._pc.op

    def solve(self, b, **kw):
        return self._pc.solve(b, **kw)


class stokes_gg_2d(_StokesAMGClass):
    """2D grad-grad + div-penalty Stokes AMG (reference stokes_gg_2d)."""


class stokes_gg_3d(_StokesAMGClass):
    """3D grad-grad + div-penalty Stokes AMG (reference stokes_gg_3d)."""


class stokes_hdg_gg_2d:
    """2D statically-condensed HDG Stokes AMG through a facet embedding.

    The reference's HDiv-HDG embedding pattern (hdiv_hdg_embedding.hpp +
    the secondary low-order sequence): the assembled higher-order facet
    system keeps a finest dyn-block smoother, the AMG hierarchy lives in
    the facet-constant aux space reached through ``E``.
    """

    def __init__(self, A, E, *, cell_pos, cell_vol, facet_cells,
                 facet_flow, options=None, **flags):
        from .precond.stokes import StokesHDGEmbeddedAMG

        if options is None:
            options = options_from_flags(flags) if flags else AMGOptions()
        self._pc = StokesHDGEmbeddedAMG(
            A,
            E,
            cell_pos=cell_pos,
            cell_vol=cell_vol,
            facet_cells=facet_cells,
            facet_flow=facet_flow,
            options=options,
        ).setup()

    def GetNLevels(self, rank: int = 0):
        return self._pc.num_levels

    def GetAMGMatrix(self):
        return self._pc.op

    def solve(self, b, **kw):
        return self._pc.solve(b, **kw)


class stokes_hdg_gg_3d(stokes_hdg_gg_2d):
    """3D statically-condensed HDG Stokes AMG through a facet embedding."""


class _StokesHDivAMGClass:
    """HDiv-variant Stokes AMG (reference stokes_hdiv_gg_*): variable
    facet DOF counts + preserved vectors."""

    def __init__(self, A, *, cell_pos, cell_vol, facet_cells, facet_flow,
                 facet_dof_counts, preserved, options=None, **flags):
        from .precond.stokes import StokesHDivAMG

        if options is None:
            options = options_from_flags(flags) if flags else AMGOptions()
        self._pc = StokesHDivAMG(
            A,
            cell_pos=cell_pos,
            cell_vol=cell_vol,
            facet_cells=facet_cells,
            facet_flow=facet_flow,
            facet_dof_counts=facet_dof_counts,
            preserved=preserved,
            options=options,
        ).setup()

    def GetNLevels(self, rank: int = 0):
        return self._pc.num_levels

    def GetNDof(self, level: int = 0, rank: int = 0):
        return self._pc.setup_levels_[level].A.shape[0]

    def GetMeshDOFs(self, level: int = 0):
        return self._pc.setup_levels_[level].dofs

    def GetPreservedVectors(self, level: int = 0):
        return self._pc.setup_levels_[level].pres

    def solve(self, b, **kw):
        return self._pc.solve(b, **kw)


class stokes_hdiv_gg_2d(_StokesHDivAMGClass):
    """2D HDiv-HDG-style Stokes AMG (reference stokes_hdiv_gg_2d)."""


class stokes_hdiv_gg_3d(_StokesHDivAMGClass):
    """3D HDiv-HDG-style Stokes AMG (reference stokes_hdiv_gg_3d)."""


# ---------------------------------------------------------------------------
# DOF-map steps + utils exports (python_coarse.cpp, python_utils.cpp)
# ---------------------------------------------------------------------------


class TransferStep:
    """One fine<->coarse transfer (`BaseDOFMapStep` py-surface)."""

    def __init__(self, P):
        self.P = P.tocsr()

    def TransferF2C(self, vf: np.ndarray) -> np.ndarray:
        """Restrict a fine vector: v_c = P^T v_f."""
        return self.P.T @ np.asarray(vf)

    def TransferC2F(self, vc: np.ndarray) -> np.ndarray:
        """Prolongate a coarse vector: v_f = P v_c."""
        return self.P @ np.asarray(vc)

    def AddC2F(self, scale: float, vf: np.ndarray, vc: np.ndarray):
        """v_f += scale * P v_c (the reference's AddC2F)."""
        vf += scale * (self.P @ np.asarray(vc))
        return vf


class DOFMap:
    """Chain of transfer steps (`DOFMap` py-export); iterable for the
    raw prolongation matrices."""

    def __init__(self, steps):
        self.steps = list(steps)

    def GetNSteps(self) -> int:
        return len(self.steps)

    def GetStep(self, k: int) -> TransferStep:
        return self.steps[k]

    def TransferF2C(self, level: int, vf: np.ndarray) -> np.ndarray:
        return self.steps[level].TransferF2C(vf)

    def TransferC2F(self, level: int, vc: np.ndarray) -> np.ndarray:
        return self.steps[level].TransferC2F(vc)

    def __len__(self):
        return len(self.steps)

    def __iter__(self):
        return (s.P for s in self.steps)

    def __getitem__(self, k):
        return self.steps[k].P


def RegularizeMatrix(mat, block_size: int = 1) -> sp.csr_matrix:
    """Kernel-stabilize near-singular diagonal blocks.

    The `RegTM`/`RegularizeMatrix` analog (utils_denseLA.hpp `RegTM`,
    elasticity_pc_impl.hpp:139): rotation-free elasticity matrices carry
    singular (or near-singular) diagonal blocks whose null modes destroy
    direct coarse inverses. Per diagonal block, eigenvalues below
    ``tol * lam_max`` are lifted to that floor (the block's eigenbasis is
    kept), which regularizes exactly the deficient subspace.
    """
    A = mat.tocsr().astype(np.float64)
    bs = int(block_size)
    if bs <= 1:
        d = A.diagonal().copy()
        scale = max(float(np.abs(d).max(initial=0.0)), 1e-300)
        fix = np.abs(d) < 1e-10 * scale
        if fix.any():
            A = A + sp.diags(np.where(fix, 1e-10 * scale, 0.0))
        return A.tocsr()
    from .sparse.host import block_diagonal_fast

    n = A.shape[0] // bs
    D = block_diagonal_fast(A, bs)
    w, V = np.linalg.eigh(D)
    lam_max = np.maximum(w.max(axis=1), 1e-300)
    floor = 1e-10 * lam_max[:, None]
    w_fix = np.maximum(w, floor)
    # only deficient blocks contribute a delta — emitting the full
    # block-diagonal COO would inflate every diagonal block's stored nnz
    # with explicit zeros
    bad = (w_fix != w).any(axis=1)
    if not bad.any():
        return A
    nb = int(bad.sum())
    delta = np.einsum(
        "nij,nj,nkj->nik", V[bad], (w_fix - w)[bad], V[bad]
    )
    rows = np.repeat(np.flatnonzero(bad) * bs, bs * bs)
    ri = rows + np.tile(np.repeat(np.arange(bs), bs), nb)
    ci = rows + np.tile(np.tile(np.arange(bs), bs), nb)
    return (
        A
        + sp.coo_matrix(
            (delta.ravel(), (ri, ci)), shape=A.shape
        ).tocsr()
    ).tocsr()


def SparseMM(A, B):
    """Sparse matrix-matrix product (reference `SparseMM`,
    python_utils.cpp:32)."""
    return (sp.csr_matrix(A) @ sp.csr_matrix(B)).tocsr()


def ToSparseMatrix(A) -> sp.csr_matrix:
    """Convert framework device/host operator formats to scipy CSR
    (reference `ToSparseMatrix`, python_utils.cpp:38)."""
    if sp.issparse(A):
        return A.tocsr()
    from .sparse.bell import BlockELL, to_scipy as _bell_to_scipy
    from .sparse.formats import DenseMatrix, DiaMatrix, StencilDia

    if isinstance(A, DiaMatrix):
        data = np.asarray(A.data, dtype=np.float64)[:, : A.nrows]
        return sp.dia_matrix(
            (data, np.asarray(A.offsets)), shape=(A.nrows, A.nrows)
        ).tocsr()
    if isinstance(A, StencilDia):
        from .transfer.stencil import synth_uniform, to_csr

        offs = np.asarray(A.offs, dtype=np.int64)
        vals = np.asarray(A.vals, dtype=np.float64)
        return to_csr(synth_uniform(A.dims, offs, vals))
    if isinstance(A, DenseMatrix):
        d = np.asarray(A.data, dtype=np.float64)
        nsc = A.nrows * A.bs
        return sp.csr_matrix(d[:nsc, :nsc])
    if isinstance(A, BlockELL):
        return _bell_to_scipy(A)
    raise TypeError(type(A))


def AMGBFCheck(A, M, thresh: float = 1e-10, verbose: bool = True):
    """Per-dof sqrt-diagonal energy-ratio diagnostic (reference
    `AMGBFCheck`, utils_sparseLA.cpp:32-120): compares sqrt(diag(A)) /
    sqrt(diag(M)) per dof; returns (avg_ratio, worst_ratio, worst_dof)."""
    dA = np.sqrt(np.maximum(ToSparseMatrix(A).diagonal(), 0.0))
    dM = np.sqrt(np.maximum(ToSparseMatrix(M).diagonal(), 0.0))
    ok = dM > thresh
    rel = dA[ok] / dM[ok]
    if len(rel) == 0:
        return 0.0, 0.0, -1
    worst = int(np.argmax(rel))
    worst_dof = int(np.flatnonzero(ok)[worst])
    if verbose:
        print(
            f"AMGBFCheck: avg rel {rel.mean():.4g}, worst "
            f"{rel[worst]:.4g} at dof {worst_dof}"
        )
    return float(rel.mean()), float(rel[worst]), worst_dof


# ---------------------------------------------------------------------------
# standalone smoothers (python_smoothers.cpp:144-391)
# ---------------------------------------------------------------------------


def _standalone_smoother(mat: sp.spmatrix, kind: str, block_size=1, **kw):
    """Build a device smoother for an arbitrary matrix + apply closure."""
    import jax.numpy as jnp

    from .config import SmootherOptions
    from .smoothers.build import build_smoother, plan_row_order

    opts = SmootherOptions(type=SmootherType(kind), **kw)
    A = mat.tocsr()
    perm, cb = plan_row_order(A, block_size, opts, 0)
    scal_perm = None
    if perm is not None:
        scal_perm = (
            perm[:, None] * block_size + np.arange(block_size)
        ).ravel()
        A = A[scal_perm][:, scal_perm].tocsr()
    Ad = bell.from_scipy(A, block_size, block_size)
    sm = build_smoother(
        A, block_size, opts, 0, Ad.nrows_pad, jnp.float32, color_bounds=cb
    )
    return _SmootherHandle(Ad, sm, scal_perm, mat.shape[0], block_size)


class _SmootherHandle:
    """Callable smoother with the reference Smooth/SmoothBack contract."""

    def __init__(self, Ad, sm, perm, n, bs):
        import jax

        self.Ad, self.sm, self.perm, self.n, self.bs = Ad, sm, perm, n, bs
        self.iperm = None if perm is None else np.argsort(perm)

    def _dev(self, v):
        import jax.numpy as jnp

        v = np.asarray(v, float)
        if self.perm is not None:
            v = v[self.perm]
        return bell.block_vec(v, self.bs, self.Ad.nrows_pad, jnp.float32)

    def _host(self, v):
        out = np.asarray(bell.flat_vec(v, self.Ad.nrows), dtype=np.float64)
        return out if self.iperm is None else out[self.iperm]

    def Smooth(self, x, b):
        from .smoothers.core import smooth

        return self._host(smooth(self.sm, self.Ad, self._dev(x), self._dev(b)))

    def SmoothBack(self, x, b):
        from .smoothers.core import smooth_back

        return self._host(
            smooth_back(self.sm, self.Ad, self._dev(x), self._dev(b))
        )


def CreateHybridGSS(mat, block_size=1, **kw):
    """Multicolor GS smoother from any matrix (ref: CreateHybridGSS)."""
    return _standalone_smoother(mat, "gs", block_size, **kw)


def CreateHybridBlockGSS(mat, blocks, steps: int = 1):
    """Block GS from user-supplied DOF blocks (ref: CreateHybridBlockGSS,
    python_smoothers.cpp:197)."""
    import jax.numpy as jnp

    from .smoothers.block import build_block_gs

    A = mat.tocsr()
    Ad = bell.from_scipy(A, 1, 1)
    sm = build_block_gs(
        A, [np.asarray(b) for b in blocks], Ad.nrows_pad, jnp.float32,
        steps=steps,
    )
    return _SmootherHandle(Ad, sm, None, mat.shape[0], 1)


def CreateJacobiSmoother(mat, block_size=1, l1: bool = True, **kw):
    return _standalone_smoother(
        mat, "l1_jacobi" if l1 else "jacobi", block_size, **kw
    )


def CreateChebyshevSmoother(mat, block_size=1, **kw):
    return _standalone_smoother(mat, "chebyshev", block_size, **kw)


def CreateDynBlockSmoother(mat, steps: int = 1, max_block: int = 8):
    """Dyn-block GS: automatic variable-size structural blocking
    (ref: CreateDynBlockSmoother, python_smoothers.cpp; dyn_block.hpp)."""
    import jax.numpy as jnp

    from .smoothers.block import build_dyn_block_gs

    A = mat.tocsr()
    Ad = bell.from_scipy(A, 1, 1)
    sm = build_dyn_block_gs(
        A, Ad.nrows_pad, jnp.float32, steps=steps, max_block=max_block
    )
    return _SmootherHandle(Ad, sm, None, mat.shape[0], 1)
