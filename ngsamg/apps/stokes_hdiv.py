"""HDiv-variant Stokes AMG: variable facet DOFs + preserved vectors.

JAX re-creation of the reference's HDiv Stokes machinery
(/root/reference/src/stokes/hdiv/):

* :class:`MeshDOFs` — variable DOFs per facet through an offsets array
  (`mesh_dofs.hpp:13-60`): facet e owns dofs [offsets[e], offsets[e+1]).
  HDiv-HDG facet spaces carry a normal flux plus tangential/higher-order
  moments, and boundary conditions make the counts VARIABLE.
* :class:`PreservedVectors` + :func:`preserved_prolongation` — the
  `PreservedVectorsMap` analog (`preserved_vectors.hpp:38-81`,
  `computeCoarseBasis`): chosen vectors (constant velocity fields, RT0)
  must stay EXACTLY representable on every coarse level. Each coarse
  facet's DOF block is built as an orthonormal basis of [special flux
  column | preserved-vector restrictions] over its fine member dofs — the
  coarse DOF count per facet is the RANK of that local system (variable),
  and the coarse coefficients of the preserved vectors come out of the
  same factorization, so P @ V_coarse == V_fine by construction.
* Interior (agglomerate-internal) fine dofs prolongate by a min-norm
  least-squares fit to the preserved vectors over the aggregate's
  incident coarse dofs — the role of the reference's agglomerate-interior
  extension.

The flux component (dof 0 of every facet) keeps the divergence-preserving
flow prolongation of :mod:`ngsamg.apps.stokes`; preserved fitting adds
columns over the non-flux components only, so coarse div-free fields still
prolongate div-free.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from ..mesh.topo import AlgebraicMesh


@dataclass
class MeshDOFs:
    """Variable DOFs per facet (mesh_dofs.hpp analog)."""

    offsets: np.ndarray  # (ne+1,) int64, ascending

    @property
    def ndof(self) -> int:
        return int(self.offsets[-1])

    @property
    def ne(self) -> int:
        return len(self.offsets) - 1

    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def dofs(self, e: int) -> np.ndarray:
        return np.arange(self.offsets[e], self.offsets[e + 1])

    @staticmethod
    def from_counts(counts) -> "MeshDOFs":
        off = np.zeros(len(counts) + 1, dtype=np.int64)
        off[1:] = np.cumsum(counts)
        return MeshDOFs(offsets=off)


@dataclass
class PreservedVectors:
    """n_special leading components + the preserved vector coordinates.

    ``vectors``: (ndof, m) — each column must remain exactly representable
    through the hierarchy (preserved_vectors.hpp:13-35).
    """

    n_special: int
    vectors: np.ndarray


def preserved_prolongation(
    mesh_f: AlgebraicMesh,
    mesh_c: AlgebraicMesh,
    v2agg: np.ndarray,
    e2ce: np.ndarray,
    dofs_f: MeshDOFs,
    pres: PreservedVectors,
    P_flux: sp.csr_matrix,
    rank_tol: float = 1e-10,
):
    """(P, dofs_c, pres_c): prolongation with exact vector preservation.

    dof 0 of each facet is the flux (special) component and prolongates
    through ``P_flux`` (the div-preserving flow prolongation, facet->facet).
    Higher dofs of each COARSE facet get an orthonormal basis spanning the
    preserved vectors' restrictions to its fine members' higher dofs
    (`computeCoarseBasis`); interior fine higher dofs fit by min-norm
    least squares over their aggregate's incident coarse dofs.
    """
    ne_f, ne_c = mesh_f.ne, mesh_c.ne
    if dofs_f.ne != ne_f:
        raise ValueError(
            f"MeshDOFs covers {dofs_f.ne} facets, dual mesh has {ne_f}"
        )
    V = pres.vectors
    m = V.shape[1]

    # --- coarse facet bases over member higher dofs -----------------------
    rows_l, cols_l, vals_l = [], [], []
    cnt_c = np.ones(ne_c, dtype=np.int64)  # dof 0 = flux, always present
    members: dict[int, list[int]] = {}
    for e in range(ne_f):
        ce = e2ce[e]
        if ce >= 0:
            members.setdefault(int(ce), []).append(e)
    c_hi_coords: list[np.ndarray] = [None] * ne_c  # per coarse edge: (k, m)
    c_hi_rows: list[np.ndarray] = [None] * ne_c  # fine dof ids of the block
    c_hi_basis: list[np.ndarray] = [None] * ne_c  # (len(rows), k)
    for ce in range(ne_c):
        fine = members.get(ce, [])
        hi = np.concatenate(
            [dofs_f.dofs(e)[1:] for e in fine]
        ) if fine else np.zeros(0, dtype=np.int64)
        if len(hi) == 0:
            continue
        W = V[hi]  # (nhi, m) preserved restrictions
        # orthonormal basis of the column span (rank-revealing)
        U, s, _vt = np.linalg.svd(W, full_matrices=False)
        k = int((s > rank_tol * max(s[0] if len(s) else 0.0, 1e-300)).sum())
        if k == 0:
            continue
        B = U[:, :k]  # (nhi, k)
        cnt_c[ce] += k
        c_hi_rows[ce] = hi
        c_hi_basis[ce] = B
        c_hi_coords[ce] = B.T @ W  # coarse coords: B @ coords == W exactly

    dofs_c = MeshDOFs.from_counts(cnt_c)

    # --- assemble P --------------------------------------------------------
    # flux components: P_flux maps coarse facet -> fine facet (facet ids);
    # place at (fine dof0, coarse dof0)
    Pf = P_flux.tocoo()
    f0 = dofs_f.offsets[:-1]
    c0 = dofs_c.offsets[:-1]
    rows_l.append(f0[Pf.row])
    cols_l.append(c0[Pf.col])
    vals_l.append(Pf.data)
    # coarse higher-dof blocks
    for ce in range(ne_c):
        if c_hi_rows[ce] is None:
            continue
        B = c_hi_basis[ce]
        hi = c_hi_rows[ce]
        k = B.shape[1]
        cdofs = np.arange(c0[ce] + 1, c0[ce] + 1 + k)
        r, c = np.meshgrid(hi, cdofs, indexing="ij")
        rows_l.append(r.ravel())
        cols_l.append(c.ravel())
        vals_l.append(B.ravel())

    # --- coarse preserved coordinates --------------------------------------
    Vc = np.zeros((dofs_c.ndof, m))
    # flux coords = the natural restriction: total oriented fine flux
    # through each coarse facet. Exact preservation on all cross facets
    # (the flow prolongation distributes proportionally) and on interior
    # facets of divergence-balanced aggregates (the tree routing is then
    # the unique consistent completion); boundary-touching aggregates
    # deviate exactly when the preserved field violates the eliminated
    # boundary conditions — as in the reference, preserved vectors are
    # meant to be consistent with the (aux) space.
    Vf_flux = V[f0]  # (ne_f, m) fine flux components (velocity units)
    cross_f = np.flatnonzero(e2ce >= 0)
    ce_of = e2ce[cross_f]
    sgn = np.where(
        v2agg[mesh_f.edges[cross_f, 0]] == mesh_c.edges[ce_of, 0], 1.0, -1.0
    )
    # velocity-unit coarse dof: flow_c * U = total oriented fine flux
    flow_f = mesh_f.edge_data["flow"]
    cflow = mesh_c.edge_data["flow"]
    np.add.at(
        Vc,
        c0[ce_of],
        (sgn * flow_f[cross_f])[:, None] * Vf_flux[cross_f],
    )
    gc = np.where(np.abs(cflow) > 1e-300, cflow, 1.0)
    Vc[c0] /= gc[:, None]
    for ce in range(ne_c):
        if c_hi_coords[ce] is None:
            continue
        k = c_hi_coords[ce].shape[0]
        Vc[c0[ce] + 1 : c0[ce] + 1 + k] = c_hi_coords[ce]

    # --- interior fine higher dofs: min-norm fit to preserved vectors ------
    interior = np.flatnonzero(e2ce < 0)
    # incident coarse edges of each aggregate
    agg_ces: dict[int, set] = {}
    for ce in range(ne_c):
        i, j = mesh_c.edges[ce]
        agg_ces.setdefault(int(i), set()).add(ce)
        agg_ces.setdefault(int(j), set()).add(ce)
    for e in interior:
        hi = dofs_f.dofs(e)[1:]
        if len(hi) == 0:
            continue
        a = int(v2agg[mesh_f.edges[e, 0]])
        ces = sorted(agg_ces.get(a, ()))
        stencil = np.concatenate(
            [np.arange(dofs_c.offsets[ce], dofs_c.offsets[ce + 1])
             for ce in ces]
        ) if ces else np.zeros(0, dtype=np.int64)
        if len(stencil) == 0:
            continue
        # row R solves R @ Vc[stencil] = V[hi] (min-norm per fine dof)
        Vs = Vc[stencil]  # (ns, m)
        R = V[hi] @ np.linalg.pinv(Vs, rcond=1e-10)  # (nhi, ns)
        r, c = np.meshgrid(hi, stencil, indexing="ij")
        rows_l.append(r.ravel())
        cols_l.append(c.ravel())
        vals_l.append(R.ravel())

    P = sp.coo_matrix(
        (
            np.concatenate(vals_l),
            (np.concatenate(rows_l), np.concatenate(cols_l)),
        ),
        shape=(dofs_f.ndof, dofs_c.ndof),
    ).tocsr()
    P.sum_duplicates()

    # --- interior FLUX correction in the aggregate cycle space -------------
    # The tree routing completes divergence uniquely on a spanning tree, so
    # non-tree interior facets of an aggregate carry none of the preserved
    # vectors' circulation. The deficit lies exactly in the aggregate's
    # interior cycle space (= ker of the local divergence), so correcting
    # there reproduces the vectors WITHOUT touching div preservation.
    resid = np.asarray(V - P @ Vc)
    agg_int: dict[int, list[int]] = {}
    for e in interior:
        agg_int.setdefault(int(v2agg[mesh_f.edges[e, 0]]), []).append(e)
    extra_r, extra_c, extra_v = [], [], []
    for a, facs in agg_int.items():
        if len(facs) < 2:
            continue
        flux_rows = f0[facs]
        if np.abs(resid[flux_rows]).max() < 1e-13:
            continue
        Ca = _local_cycles(mesh_f, facs)
        if Ca is None:
            continue
        y, *_ = np.linalg.lstsq(Ca, resid[flux_rows], rcond=None)
        corr = Ca @ y  # (nfacs, m) cycle-space part of the deficit
        ces = sorted(agg_ces.get(a, ()))
        if not ces:
            continue
        stencil = np.concatenate(
            [np.arange(dofs_c.offsets[ce], dofs_c.offsets[ce + 1])
             for ce in ces]
        )
        X = corr @ np.linalg.pinv(Vc[stencil], rcond=1e-10)
        r, c = np.meshgrid(flux_rows, stencil, indexing="ij")
        extra_r.append(r.ravel())
        extra_c.append(c.ravel())
        extra_v.append(X.ravel())
    if extra_r:
        dP = sp.coo_matrix(
            (
                np.concatenate(extra_v),
                (np.concatenate(extra_r), np.concatenate(extra_c)),
            ),
            shape=P.shape,
        ).tocsr()
        P = (P + dP).tocsr()
    return P, dofs_c, PreservedVectors(pres.n_special, Vc)


def _local_cycles(mesh_f: AlgebraicMesh, facs: list) -> np.ndarray | None:
    """Fundamental cycle basis of an aggregate's interior facet subgraph.

    Columns are oriented cycle vectors over ``facs`` — a basis of the
    local divergence kernel (cf. apps/stokes.build_loops_tree, here on the
    aggregate subgraph only)."""
    cells = {}
    for e in facs:
        for c in mesh_f.edges[e]:
            cells.setdefault(int(c), len(cells))
    nc = len(cells)
    parent = np.full(nc, -1, dtype=np.int64)
    pedge = np.full(nc, -1, dtype=np.int64)  # local facet slot
    depth = np.zeros(nc, dtype=np.int64)
    intree = np.zeros(len(facs), dtype=bool)
    visited = np.zeros(nc, dtype=bool)
    adj: list[list] = [[] for _ in range(nc)]
    for t, e in enumerate(facs):
        i, j = mesh_f.edges[e]
        adj[cells[int(i)]].append((cells[int(j)], t))
        adj[cells[int(j)]].append((cells[int(i)], t))
    from collections import deque

    for root in range(nc):
        if visited[root]:
            continue
        visited[root] = True
        q = deque([root])
        while q:
            c = q.popleft()
            for nb, t in adj[c]:
                if not visited[nb]:
                    visited[nb] = True
                    parent[nb] = c
                    pedge[nb] = t
                    depth[nb] = depth[c] + 1
                    intree[t] = True
                    q.append(nb)
    nontree = np.flatnonzero(~intree)
    if len(nontree) == 0:
        return None
    cols = []
    for t in nontree:
        e = facs[t]
        a, b = (cells[int(x)] for x in mesh_f.edges[e])
        vec = np.zeros(len(facs))
        vec[t] = 1.0  # traversal a -> b (stored orientation)
        u, v = b, a
        while u != v:
            if depth[u] >= depth[v]:
                td = int(pedge[u])
                i0 = cells[int(mesh_f.edges[facs[td], 0])]
                vec[td] += 1.0 if i0 == u else -1.0
                u = int(parent[u])
            else:
                td = int(pedge[v])
                i0 = cells[int(mesh_f.edges[facs[td], 0])]
                vec[td] -= 1.0 if i0 == v else -1.0
                v = int(parent[v])
        cols.append(vec)
    C = np.stack(cols, axis=1)
    # velocity-unit kernel: flux_e = flow_e * u_e, so incidence cycles
    # scale by 1/flow (cf. apps/stokes._flow_scale)
    fl = mesh_f.edge_data["flow"][facs]
    gf = np.where(np.abs(fl) > 1e-300, 1.0 / np.where(fl == 0, 1.0, fl), 1.0)
    return gf[:, None] * C
