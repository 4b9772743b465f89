"""Algebraic mesh: the light-weight topology AMG coarsens.

JAX equivalent of the reference's `TopologicMesh`/`BlockTM`/
`BlockAlgMesh` (/root/reference/src/base/mesh/base_mesh.hpp:18-340,
alg_mesh.hpp:19-186): vertices + undirected edges with *attached* per-vertex
and per-edge energy data. Instead of EQC-blocked node storage with
cumulate/distribute parallel statuses, data lives in plain SoA numpy arrays
(host side, setup only); ownership masks for the sharded solve phase are
attached per level by :mod:`ngsamg.parallel`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp


@dataclass
class AlgebraicMesh:
    """Vertices + edges + attached data (host-side, setup phase)."""

    nv: int
    edges: np.ndarray  # (ne, 2) int64, sorted i < j, unique
    vertex_data: dict = field(default_factory=dict)  # name -> (nv, ...) array
    edge_data: dict = field(default_factory=dict)  # name -> (ne, ...) array

    @property
    def ne(self) -> int:
        return len(self.edges)

    def edge_graph(self, weights: np.ndarray | None = None) -> sp.csr_matrix:
        """Symmetric CSR adjacency with per-edge weights (default: edge id).

        The reference's `GetEdgeCM` (base_mesh.hpp:47).
        """
        i, j = self.edges[:, 0], self.edges[:, 1]
        w = weights if weights is not None else np.arange(self.ne) + 1.0
        from ..native import edges_to_adj

        G = edges_to_adj(self.edges, w, self.nv)
        if G is not None:
            return G
        G = sp.coo_matrix(
            (np.concatenate([w, w]), (np.concatenate([i, j]), np.concatenate([j, i]))),
            shape=(self.nv, self.nv),
        )
        return G.tocsr()

    def edge_id_graph(self):
        """CSR whose .data holds edge indices (for row-wise edge iteration)."""
        i, j = self.edges[:, 0], self.edges[:, 1]
        eid = np.arange(self.ne)
        G = sp.coo_matrix(
            (
                np.concatenate([eid, eid]),
                (np.concatenate([i, j]), np.concatenate([j, i])),
            ),
            shape=(self.nv, self.nv),
        ).tocsr()
        return G


def scatter_add(idx: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """Sum ``vals[k]`` into row ``idx[k]`` of an (n, *vals.shape[1:]) array.

    bincount-based scatter-add: ~10-30x faster than ``np.add.at`` (an
    unbuffered element-at-a-time ufunc) on multi-million-entry mesh-data
    mappings. Always accumulates in float64.
    """
    vals = np.asarray(vals)
    if vals.ndim == 1:
        return np.bincount(idx, weights=vals, minlength=n)
    flat = vals.reshape(len(vals), -1)
    out = np.empty((n, flat.shape[1]), dtype=np.float64)
    for k in range(flat.shape[1]):
        out[:, k] = np.bincount(idx, weights=flat[:, k], minlength=n)
    return out.reshape((n,) + vals.shape[1:])


def mesh_from_matrix_graph(W: sp.csr_matrix) -> AlgebraicMesh:
    """Build the edge list from a symmetric scalar connectivity graph.

    The reference converts the sparse-matrix graph to a `BlockTM` in
    `BTM_Alg` (src/base/precond/amg_pc_vertex_impl.hpp:941-1090); here the
    edge list is simply the strict upper triangle of the off-diagonal pattern.
    """
    C = sp.triu(W, k=1).tocoo()
    edges = np.stack([C.row, C.col], axis=1).astype(np.int64)
    return AlgebraicMesh(nv=W.shape[0], edges=edges)


def map_edges(mesh: AlgebraicMesh, v2agg: np.ndarray, n_agg: int):
    """Coarse edge list + fine-edge -> coarse-edge map under aggregation.

    Mirrors `BaseAgglomerateCoarseMap::MapEdges`
    (src/base/coarsening/agglomerate_map.cpp): coarse edges are the
    deduplicated aggregate pairs of fine edges; fine edges interior to an
    aggregate map to -1.

    Returns (coarse_edges (nec,2), e2ce (ne,) int64 with -1 for collapsed).
    """
    from ..native import map_edges_agg

    nat = map_edges_agg(mesh.edges, v2agg, n_agg)
    if nat is not None:
        return nat
    ci = v2agg[mesh.edges[:, 0]]
    cj = v2agg[mesh.edges[:, 1]]
    lo = np.minimum(ci, cj)
    hi = np.maximum(ci, cj)
    # edges touching dropped vertices (v2agg == -1) are collapsed, not
    # cross edges — a negative lo would corrupt the key arithmetic below
    cross = (lo != hi) & (lo >= 0)
    key = lo.astype(np.int64) * n_agg + hi
    e2ce = np.full(mesh.ne, -1, dtype=np.int64)
    if cross.any():
        uniq, inv = np.unique(key[cross], return_inverse=True)
        e2ce[cross] = inv
        coarse_edges = np.stack([uniq // n_agg, uniq % n_agg], axis=1)
    else:
        coarse_edges = np.zeros((0, 2), dtype=np.int64)
    return coarse_edges, e2ce
