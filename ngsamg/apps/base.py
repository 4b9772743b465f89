"""Energy abstraction: what an AMG application must provide.

The reference parameterizes its vertex factory over an ENERGY class
(`VertexAMGFactory<ENERGY, TMESH, BS>`,
/root/reference/src/base/factory/vertex_factory.hpp:13-99) with per-vertex and
per-edge energy data attached to the algebraic mesh, a transport operation
``Q`` moving DOF coefficients between vertex locations
(identity for H1, rigid-body extension for elasticity —
src/h1/h1_energy.hpp, src/elasticity/elasticity_energy.hpp:31-150), and a
"replacement matrix" assembled from edge energies
(src/base/factory/aux_mat.hpp `AssembleAhatSparse`).

Here the same contract is a small ABC operating on
:class:`ngsamg.mesh.topo.AlgebraicMesh` host data with vectorized numpy.
"""

from __future__ import annotations

import abc

import numpy as np
import scipy.sparse as sp

from ..mesh.topo import AlgebraicMesh


class Energy(abc.ABC):
    """PDE-specific energy: mesh data, transport, strength, replacement."""

    #: DOFs per vertex in the AMG space (1..3 H1, 3/6 elasticity)
    dpv: int

    #: whether coarsening should use the robust (generalized-EVP) SOC by
    #: default (config CoarsenOptions.robust=None defers to this; the
    #: reference enables robust coarsening for elasticity,
    #: ENABLE_ROBUST_ELASTICITY_COARSENING)
    default_robust: bool = False

    @abc.abstractmethod
    def build_finest_mesh(
        self, A: sp.spmatrix, coords: np.ndarray | None
    ) -> AlgebraicMesh:
        """Extract topology + energy data from the assembled matrix.

        The ALG energy mode (amg_pc.hpp:78; H1: h1_impl.hpp:384-431,
        elasticity: elasticity_pc_impl.hpp:226-310).
        """

    @abc.abstractmethod
    def soc(self, mesh: AlgebraicMesh) -> np.ndarray:
        """Per-edge scalar strength of connection (>= 0, symmetric)."""

    @abc.abstractmethod
    def transport(self, pos_from: np.ndarray, pos_to: np.ndarray) -> np.ndarray:
        """Batched Q(a -> b): (m, dpv, dpv) coefficient transport blocks.

        A coefficient vector u_a at location a represents the same field as
        Q(a->b) u_a at location b (rigid-body extension for elasticity,
        elasticity_energy.hpp:31-150 `GetQiToj`). Identity for H1.
        """

    @abc.abstractmethod
    def replacement_matrix(self, mesh: AlgebraicMesh) -> sp.spmatrix:
        """Assemble the aux ("replacement") matrix A-hat from edge energies.

        Block row/col size = dpv. Used for prolongation smoothing
        (aux_mat.hpp `AssembleAhatSparse`, `CalcRMBlock`).
        """

    @abc.abstractmethod
    def map_data(
        self,
        mesh: AlgebraicMesh,
        v2agg: np.ndarray,
        n_agg: int,
        coarse_edges: np.ndarray,
        e2ce: np.ndarray,
    ) -> AlgebraicMesh:
        """Coarse mesh with mapped (summed / transported) energy data."""

    def vertex_positions(self, mesh: AlgebraicMesh) -> np.ndarray | None:
        return mesh.vertex_data.get("pos")

    def embedding_matrix(self, mesh: AlgebraicMesh) -> sp.spmatrix | None:
        """Optional finest-level embedding E: AMG space -> FEM space.

        The reference's `BuildEmbedding` (amg_pc_vertex_impl.hpp:622-795),
        e.g. disp-only FEM DOFs embedded into the disp+rot elasticity AMG
        space. None (identity) for H1.
        """
        return None
