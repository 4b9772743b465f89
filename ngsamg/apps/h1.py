"""H1 (scalar / vector diffusion) AMG energy.

JAX re-creation of the reference's H1 component
(/root/reference/src/h1/h1_energy.hpp, h1.hpp:45-138, h1_impl.hpp:384-431):

* mesh edge data: edge weight = |trace(a_ij)| (H1EData, h1.hpp:66-74)
* mesh vertex data: L2 weight = trace(a_ii) + sum_j trace(a_ij)
  (H1VData; the signed row sum isolates the zero-order term,
  h1_impl.hpp:384-431 `BuildAlgMesh_ALG_scal`)
* transport Q == identity (h1_energy.hpp:123)
* replacement-matrix block for edge (i,j) with weight w:
  [[w, -w], [-w, w]] (x) I_bs (h1_energy.hpp:236-273 `CalcRMBlock`)

For vector-valued H1 ("multidim"/compound, exports h1_2d/h1_3d) the graph is
identical and all blocks are w * I_bs; coarsening decisions are made on the
scalar weights exactly as in the reference.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..mesh.topo import AlgebraicMesh
from ..sparse.host import to_bsr
from .base import Energy


class H1Energy(Energy):
    transport_kind = "identity"  # native truncate_prol kernel dispatch

    def __init__(self, bs: int = 1):
        self.bs = bs
        self.dpv = bs

    # -- finest-level mesh ------------------------------------------------
    def build_finest_mesh(self, A, coords=None) -> AlgebraicMesh:
        bs = self.bs
        if bs == 1:
            T = A.tocsr()
        else:
            B = to_bsr(A, bs)
            tr = np.einsum("nii->n", B.data)
            nv = B.shape[0] // bs
            T = sp.csr_matrix((tr, B.indices, B.indptr), shape=(nv, nv))
        from ..native import finest_mesh_scal

        # Edges keep every off-diagonal coupling with SIGNED weight
        # -trace(a_ij): attractive couplings positive, repulsive
        # negative. Strength/energy consumers clamp to the attractive
        # part (the standard SA strength filter — the reference keeps
        # |trace a_ij|, h1_impl.hpp:384-431, which on low-quality meshes
        # with ~25% positive off-diagonals treats repulsive couplings as
        # strong and costs ~2x in PCG iterations at 1M DoF), while
        # coarse-level Galerkin weight sums (map_data) stay signed so
        # repulsive couplings CANCEL attractive ones between aggregates
        # — without this, SPW merges sub-clusters whose net coupling is
        # ~0 and the two-grid correction carries a near-kernel mode.
        res = finest_mesh_scal(T, signed_wt=True)
        if res is not None:
            # fused native pass (diag, signed rowsum, upper edges, wt)
            diag, rsum, edges, ewt = res
            vwt = np.maximum(rsum, 0.0)
            mesh = AlgebraicMesh(nv=T.shape[0], edges=edges)
        else:
            if bs == 1:
                T = T.copy()
            # vertex weight: signed row sum incl. diagonal == L2 part
            rsum = np.asarray(T.sum(axis=1)).ravel()
            vwt = np.maximum(rsum, 0.0)
            diag = T.diagonal().copy()
            T.setdiag(0.0)
            T.eliminate_zeros()
            # edge list + signed weight -trace(a_ij), upper triangle
            U = sp.triu(T, k=1).tocoo()
            mesh = AlgebraicMesh(
                nv=T.shape[0],
                edges=np.stack([U.row, U.col], axis=1).astype(np.int64),
            )
            ewt = -U.data
        mesh.vertex_data["l2wt"] = vwt
        mesh.vertex_data["diag"] = diag
        mesh.edge_data["wt"] = ewt
        if coords is not None:
            mesh.vertex_data["pos"] = np.asarray(coords, dtype=np.float64)
        return mesh

    # -- strength of connection ------------------------------------------
    def soc(self, mesh: AlgebraicMesh) -> np.ndarray:
        """Harmonic-mean normalized edge strength.

        s_e = w_e * (1/d_i + 1/d_j) with d = replacement-matrix diagonal
        (sum of incident edge weights + L2 weight), following the harmonic
        SOC of the reference agglomerators (agglomerator_utils.hpp,
        mis_agg ecw options).
        """
        # attractive part only — edge weights are SIGNED (net-repulsive
        # coarse couplings must not look strong)
        w = np.maximum(mesh.edge_data["wt"], 0.0)
        i, j = mesh.edges[:, 0], mesh.edges[:, 1]
        nv = mesh.nv
        # bincount, not np.add.at: ~20x on multi-million-edge levels
        d = (
            mesh.vertex_data["l2wt"]
            + np.bincount(i, weights=w, minlength=nv)
            + np.bincount(j, weights=w, minlength=nv)
        )
        d = np.maximum(d, 1e-300)
        return w * 0.5 * (1.0 / d[i] + 1.0 / d[j])

    # -- fused native matching round ---------------------------------------
    def spw_round(self, mesh: AlgebraicMesh, theta: float, can_match):
        """One fused matching round (native): returns partner or None.

        Exact re-implementation of soc() + edge_graph() +
        pairwise.handshake_match in one C++ pass (native.spw_round_h1).
        """
        from ..native import spw_round_h1

        w = mesh.edge_data.get("wt")
        l2 = mesh.vertex_data.get("l2wt")
        if w is None or l2 is None:
            return None
        return spw_round_h1(mesh.edges, w, l2, can_match, theta)

    # -- transport --------------------------------------------------------
    def transport(self, pos_from, pos_to) -> np.ndarray:
        m = len(pos_from) if pos_from is not None else len(pos_to)
        return np.broadcast_to(np.eye(self.dpv), (m, self.dpv, self.dpv)).copy()

    # -- replacement (aux) matrix ----------------------------------------
    def replacement_matrix(self, mesh: AlgebraicMesh) -> sp.spmatrix:
        nv, bs = mesh.nv, self.bs
        i, j = mesh.edges[:, 0], mesh.edges[:, 1]
        # attractive part only (signed edge weights): the aux matrix must
        # stay SPD — this is the SA filtered-matrix convention
        w = np.maximum(mesh.edge_data["wt"], 0.0)
        d = mesh.vertex_data["l2wt"].copy()
        np.add.at(d, i, w)
        np.add.at(d, j, w)
        rows = np.concatenate([i, j, np.arange(nv)])
        cols = np.concatenate([j, i, np.arange(nv)])
        vals = np.concatenate([-w, -w, d])
        Ahat = sp.coo_matrix((vals, (rows, cols)), shape=(nv, nv)).tocsr()
        if bs == 1:
            return Ahat
        return sp.kron(Ahat, sp.eye(bs), format="bsr")

    # -- coarse data mapping ----------------------------------------------
    def map_data(
        self, mesh, v2agg, n_agg, coarse_edges, e2ce, diag_stab_boost=0.0
    ):
        cmesh = AlgebraicMesh(nv=n_agg, edges=coarse_edges)
        # edge weights: sum fine cross-edge weights per coarse edge
        m = e2ce >= 0
        cmesh.edge_data["wt"] = np.bincount(
            e2ce[m], weights=mesh.edge_data["wt"][m],
            minlength=len(coarse_edges),
        )
        # vertex weights: sum of members
        act = v2agg >= 0
        agg_act = v2agg[act]
        l2c = np.bincount(
            agg_act, weights=mesh.vertex_data["l2wt"][act],
            minlength=n_agg,
        )
        if diag_stab_boost != 0.0 and (~m).any():
            # diagStabBoost (spw_agg_impl.hpp:516), scalar form: retain
            # 2*boost of in-agglomerate (attractive) edge weight in the
            # coarse strength diagonal
            fi, fj = mesh.edges[~m, 0], mesh.edges[~m, 1]
            ci = v2agg[fi]
            same = (ci >= 0) & (ci == v2agg[fj])
            if same.any():
                wdrop = np.maximum(mesh.edge_data["wt"][~m][same], 0.0)
                l2c += (2.0 * float(diag_stab_boost)) * np.bincount(
                    ci[same], weights=wdrop, minlength=n_agg
                )
        cmesh.vertex_data["l2wt"] = l2c
        pos = mesh.vertex_data.get("pos")
        if pos is not None:
            cnt = np.maximum(
                np.bincount(agg_act, minlength=n_agg), 1.0
            )
            cmesh.vertex_data["pos"] = np.stack(
                [
                    np.bincount(
                        agg_act, weights=pos[act, k], minlength=n_agg
                    )
                    / cnt
                    for k in range(pos.shape[1])
                ],
                axis=1,
            )
        return cmesh
