"""Successive pairwise-agglomeration coarsening (SPW), data-parallel form.

The reference's default coarsener `SPWAgglomerator`
(/root/reference/src/base/coarsening/spw_agg.hpp:15-165, spw_agg_impl.hpp:
1440-1831) runs `numRounds` rounds of greedy pairwise matching, each round on
the intermediate local coarse mesh, producing aggregates of size ~2^rounds.
Its greedy sequential loop does not vectorize, so this module recasts
each round as *handshake matching* (local-max / mutual-proposal matching):

  repeat:
    every unmatched vertex proposes to its strongest eligible neighbor;
    mutual proposals become matched pairs;
  until no new matches form.

This is the classic parallel half-approximation to greedy matching; every
step is a vectorized row-wise argmax over the strength graph, i.e. exactly
the shape of computation that later moves into device kernels. Round-0
special cases follow the reference (spw_agg_impl.hpp round 0): Dirichlet
drop, L2-dominant vertex drop, isolated-vertex handling; the final
orphan-adoption pass mirrors the reference's `allrobust`/adoption round.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..sparse.host import csr_rowwise_argmax, csr_rowwise_max


def handshake_match(S: sp.csr_matrix, theta: float, can_match: np.ndarray):
    """One round of mutual-proposal matching on strength graph ``S``.

    ``S`` is a symmetric scalar CSR of edge strengths (>= 0).
    ``can_match`` masks vertices allowed to participate.
    Returns ``partner`` (n,) int64: matched partner index, or -1 if unmatched.
    """
    n = S.shape[0]
    indptr, indices, vals = S.indptr, S.indices, S.data

    # native single-pass implementation when built (ngsamg.native);
    # the tie-break jitter below is applied in-kernel (jitter=True)
    from ..native import handshake_match as _native_match

    nat = _native_match(
        indptr, indices, vals, can_match, theta, 8, jitter=True
    )
    if nat is not None:
        return np.asarray(nat)

    rowmax = csr_rowwise_max(indptr, vals)
    # Symmetric tie-break jitter: on structured grids all strengths tie and
    # deterministic argmax yields zero mutual proposals (every vertex points
    # "up" its row). A tiny multiplicative hash of the unordered vertex pair
    # breaks ties identically on both sides of each edge without affecting
    # real strength ordering.
    rows0 = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    lo = np.minimum(rows0, indices)
    hi = np.maximum(rows0, indices)
    h = (lo * np.int64(2654435761) + hi * np.int64(40503)) & np.int64(
        0xFFFFFFFF
    )
    vals = vals * (1.0 + 1e-9 * (h.astype(np.float64) / 2**32))
    # eligibility by strength threshold (relative to both endpoints' rows,
    # cf. the reference's strength filters in agglomerator_utils.hpp)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    thresh = theta * np.minimum(rowmax[rows], rowmax[indices])
    strong = vals >= np.maximum(thresh, 1e-300)

    partner = np.full(n, -1, dtype=np.int64)
    avail = can_match.copy()
    for _ in range(8):  # handshake iterations; converges fast in practice
        valid = strong & avail[rows] & avail[indices]
        best, _bv = csr_rowwise_argmax(indptr, indices, vals, valid=valid)
        best[~avail] = -1
        # mutual proposals
        cand = np.flatnonzero(best >= 0)
        mutual = cand[best[best[cand]] == cand]
        new = mutual[mutual < best[mutual]]  # each pair once
        if len(new) == 0:
            break
        a, b = new, best[new]
        partner[a] = b
        partner[b] = a
        avail[a] = False
        avail[b] = False
    return partner


def aggregates_from_partner(partner: np.ndarray, active: np.ndarray):
    """Pairs + singletons -> aggregate index array (contiguous 0..n_agg-1).

    Inactive (dropped) vertices get -1.
    """
    n = len(partner)
    v2agg = np.full(n, -1, dtype=np.int64)
    # aggregate representative: min(v, partner) for pairs, v for singletons
    ar = np.arange(n)
    rep = np.where(partner >= 0, np.minimum(ar, partner), ar)
    # O(n) compaction (ids in ascending-representative order, exactly the
    # ordering np.unique produced): every representative is its own rep,
    # so cumsum over the is-rep flags numbers them ascending
    is_rep = active & (rep == ar)
    ids = np.cumsum(is_rep) - 1
    act = active & (rep >= 0)
    v2agg[act] = ids[rep[act]]
    return v2agg, int(is_rep.sum())


def coarse_strength_graph(S: sp.csr_matrix, v2agg: np.ndarray, n_agg: int):
    """Galerkin-collapse the strength graph onto aggregates (sum weights)."""
    from ..native import collapse_graph as _native_collapse

    Sc = _native_collapse(S, v2agg, n_agg)
    if Sc is not None:
        return Sc
    n = S.shape[0]
    act = v2agg >= 0
    rows = np.flatnonzero(act)
    C = sp.coo_matrix(
        (np.ones(len(rows)), (rows, v2agg[rows])), shape=(n, n_agg)
    ).tocsr()
    Sc = (C.T @ S @ C).tocsr()
    Sc.setdiag(0.0)
    Sc.eliminate_zeros()
    return Sc


def spw_aggregate(
    S: sp.csr_matrix,
    *,
    rounds: int = 2,
    theta: float = 0.08,
    adopt_orphans: bool = True,
    active: np.ndarray | None = None,
    max_agg: int | None = None,
    aaf: float | None = None,
) -> tuple[np.ndarray, int]:
    """Multi-round successive pairwise aggregation.

    Parameters mirror SPWConfig (spw_agg.hpp:15-60): ``rounds`` = numRounds,
    ``theta`` the strength threshold. ``active`` masks vertices that take part
    (Dirichlet/dropped vertices excluded). ``aaf`` (when set) is the
    reference's goal coarsening factor (base_factory.hpp `aaf`): rounds
    repeat until n_coarse <= aaf * n, bounded by 10 rounds. Returns
    (v2agg, n_agg) with v2agg[v] = -1 for inactive vertices.
    """
    n = S.shape[0]
    if active is None:
        active = np.ones(n, dtype=bool)

    # composed map fine vertex -> current coarse vertex
    v2c = np.where(active, 0, -1).astype(np.int64)
    act_idx = np.flatnonzero(active)
    v2c[act_idx] = np.arange(len(act_idx))
    n_cur = len(act_idx)
    n0 = n_cur
    if n_cur == n:  # all active: skip the (identity) submatrix copy
        S_cur = S.tocsr()
    else:
        S_cur = S[act_idx][:, act_idx].tocsr()

    if aaf is not None:
        rounds = 10  # goal-driven: bound, not target
    sizes = np.ones(n_cur, dtype=np.int64)  # fine vertices per coarse vertex
    for _round in range(rounds):
        if aaf is not None and n_cur <= aaf * n0:
            break
        # aggregate-size cap (reference SPW size caps): full aggregates
        # no longer participate in matching
        cm = (
            np.ones(n_cur, dtype=bool)
            if max_agg is None
            else sizes * 2 <= max_agg
        )
        if not cm.any():
            break
        partner = handshake_match(S_cur, theta, can_match=cm)
        c2agg, n_agg = aggregates_from_partner(
            partner, np.ones(n_cur, dtype=bool)
        )
        if n_agg >= n_cur:  # no progress
            break
        # compose
        mask = v2c >= 0
        v2c[mask] = c2agg[v2c[mask]]
        sizes = np.bincount(
            c2agg, weights=sizes.astype(np.float64), minlength=n_agg
        ).astype(np.int64)
        n_cur = n_agg
        S_cur = coarse_strength_graph(S_cur, c2agg, n_agg)

    if adopt_orphans:
        v2c, n_cur = _adopt_orphans(S_cur, v2c, n_cur)
    return v2c, n_cur


def big_soc_vet(
    energy,
    mesh,
    v2c: np.ndarray,
    partner: np.ndarray,
    rho: float,
    max_members: int = 16,
    Dfull: np.ndarray | None = None,
) -> np.ndarray:
    """Agglomerate-wide stability acceptance check (`bigSOC`).

    The reference's `AggregateWideStabilityCheck`
    (agglomerator_utils.hpp:394-539, enabled by `checkBigSOC`,
    spw_agg.hpp:31): before two agglomerates merge, require the
    diagonal smoother M (full aux diagonals, including outside
    connections) to be rho-dominated by the SUB-assembled replacement
    energy A of the union ORTHOGONAL to the rigid-body space:

        A - rho (M - M P (P^T M P)^+ P^T M)  >=  0   (SSPD)

    with P the Q-transported kernel basis (AssembleAhatBlock /
    agglomerator_utils.hpp:296-360 conventions). Matched pairs failing
    the check are un-matched for the round (the handshake analog of the
    reference rejecting a non-viable neighbor and falling through).

    ``mesh``/``v2c`` are the FINE mesh and the composed fine->current
    aggregation — the check is member-resolved like the reference's
    (fAggData + getFullAgg). Unions of fewer than 3 members auto-pass
    (reference n < 3 early-out); unions above ``max_members`` auto-pass
    (the reference's agg sizes are bounded by 2^rounds).

    Returns the vetted ``partner`` array.
    """
    n_cur = int(v2c.max()) + 1 if len(v2c) else 0
    a = np.flatnonzero(
        (partner >= 0) & (np.arange(len(partner)) < partner)
    )
    if not len(a):
        return partner
    b = partner[a]
    npair = len(a)
    # pair id per CURRENT coarse vertex (-1 = not in a vetted pair)
    pair_of = np.full(max(n_cur, 1), -1, dtype=np.int64)
    pair_of[a] = np.arange(npair)
    pair_of[b] = np.arange(npair)
    # fine members per pair (sorted fine ids — QuickSort(allMems))
    act = v2c >= 0
    fine_ids = np.flatnonzero(act)
    fine_pair = pair_of[v2c[fine_ids]]
    sel = fine_pair >= 0
    fine_ids, fine_pair = fine_ids[sel], fine_pair[sel]
    order = np.lexsort((fine_ids, fine_pair))
    fine_ids, fine_pair = fine_ids[order], fine_pair[order]
    counts = np.bincount(fine_pair, minlength=npair)
    offs = np.concatenate([[0], np.cumsum(counts)])
    # local member slot of each fine id within its pair
    slot = np.arange(len(fine_ids)) - offs[fine_pair]
    # fine id -> (pair, slot) lookup
    v_pair = np.full(mesh.nv, -1, dtype=np.int64)
    v_slot = np.zeros(mesh.nv, dtype=np.int64)
    v_pair[fine_ids] = fine_pair
    v_slot[fine_ids] = slot

    d = energy.dpv
    pos = mesh.vertex_data["pos"]
    E = mesh.edge_data["mat"]
    edges = mesh.edges
    if Dfull is None:  # caller may hoist this out of the round loop
        Dfull = energy.aux_diagonal(mesh)

    # edges interior to a pair's union
    ei, ej = edges[:, 0], edges[:, 1]
    pe = v_pair[ei]
    in_pair = (pe >= 0) & (pe == v_pair[ej])
    reject = np.zeros(npair, dtype=bool)
    sizes = counts
    for m in np.unique(sizes):
        if m < 3:
            continue  # reference early-out: unions of < 3 auto-pass
        if m > max_members:
            continue  # bounded agg sizes; larger unions auto-pass
        pids = np.flatnonzero(sizes == m)
        if not len(pids):
            continue
        B = len(pids)
        bidx = np.full(npair, -1, dtype=np.int64)
        bidx[pids] = np.arange(B)
        mem = fine_ids[
            (offs[pids][:, None] + np.arange(m)).ravel()
        ].reshape(B, m)
        # sub-assembled replacement energy over the union's edges
        A_blk = np.zeros((B, m, m, d, d))
        esel = np.flatnonzero(in_pair & (bidx[pe] >= 0))
        if len(esel):
            i_f, j_f = ei[esel], ej[esel]
            pb = bidx[pe[esel]]
            si, sj = v_slot[i_f], v_slot[j_f]
            mid = 0.5 * (pos[i_f] + pos[j_f])
            Qim = energy.transport(pos[i_f], mid)
            Qjm = energy.transport(pos[j_f], mid)
            Ee = E[esel]
            QiE = np.swapaxes(Qim, -1, -2) @ Ee
            QjE = np.swapaxes(Qjm, -1, -2) @ Ee
            np.add.at(A_blk, (pb, si, si), QiE @ Qim)
            np.add.at(A_blk, (pb, sj, sj), QjE @ Qjm)
            np.add.at(A_blk, (pb, si, sj), -(QiE @ Qjm))
            np.add.at(A_blk, (pb, sj, si), -(QjE @ Qim))
        A_mat = A_blk.transpose(0, 1, 3, 2, 4).reshape(
            B, m * d, m * d
        )
        # block-diagonal smoother of FULL aux diagonals
        M_mat = np.zeros((B, m * d, m * d))
        for k in range(m):
            M_mat[:, k * d:(k + 1) * d, k * d:(k + 1) * d] = Dfull[
                mem[:, k]
            ]
        # rigid-body space transported from member 0
        P = np.zeros((B, m * d, d))
        for k in range(m):
            P[:, k * d:(k + 1) * d, :] = energy.transport(
                pos[mem[:, k]], pos[mem[:, 0]]
            )
        PtM = np.swapaxes(P, -1, -2) @ M_mat  # (B, d, md)
        PtMP = PtM @ P
        PtMP_inv = np.linalg.pinv(PtMP, rcond=1e-12, hermitian=True)
        M_ortho = M_mat - np.swapaxes(PtM, -1, -2) @ (PtMP_inv @ PtM)
        G = A_mat - rho * M_ortho
        G = 0.5 * (G + np.swapaxes(G, -1, -2))
        lam = np.linalg.eigvalsh(G)
        scale = np.maximum(
            np.abs(lam).max(axis=1), 1e-300
        )
        # SSPD: semi-definiteness up to relative roundoff (CheckForSSPD)
        reject[pids] = lam[:, 0] < -1e-10 * scale
    bad = np.flatnonzero(reject)
    if len(bad):
        partner = partner.copy()
        partner[a[bad]] = -1
        partner[b[bad]] = -1
    return partner


def spw_aggregate_energy(
    energy,
    mesh,
    *,
    rounds: int = 2,
    theta: float = 0.08,
    adopt_orphans: bool = True,
    active: np.ndarray | None = None,
    aaf: float | None = None,
    max_agg: int | None = None,
    robust: bool = True,
    neib_boost: bool = False,
    scal_rel_thresh: float = 0.25,
    soc_reduction: str | None = None,
    diag_stab_boost: float = 0.0,
    big_soc: bool = False,
    big_soc_rho: float | None = None,
) -> tuple[np.ndarray, int]:
    """SPW with per-round energy re-evaluation (robust pick/check).

    The reference's SPW consults generalized EVPs per candidate pair and
    re-checks agglomerates against the CURRENT intermediate coarse energies
    (spw_agg_impl.hpp:1440-1831, agglomerator_utils.hpp:764-885). The
    data-parallel counterpart: each round rebuilds the coarse algebraic
    mesh (Q-transported energy sums, `energy.map_data`) and re-scores all
    candidate pairs with the robust (pencil-EVP) SOC before the handshake
    matching — every matching decision is made against up-to-date energies
    rather than a Galerkin-collapsed scalar graph.
    """
    from ..mesh.topo import map_edges

    n = mesh.nv
    if active is None:
        active = np.ones(n, dtype=bool)
    v2c = np.full(n, -1, dtype=np.int64)
    act_idx = np.flatnonzero(active)
    v2c[act_idx] = np.arange(len(act_idx))
    # mesh must be reduced to active vertices only on the first round via
    # the matching mask (map_data drops v2agg == -1 afterwards)
    cur_mesh = mesh
    cur_active = active.copy()
    n_cur = len(act_idx)
    n0 = n_cur
    sizes = np.ones(cur_mesh.nv, dtype=np.int64)
    if aaf is not None:
        rounds = 10
    use_robust = robust and hasattr(energy, "soc_robust")
    rob_kw = {}
    if use_robust:
        if soc_reduction is not None:
            rob_kw["reduction"] = soc_reduction
        if neib_boost:
            rob_kw["neib_boost"] = True
    map_kw = (
        {"diag_stab_boost": float(diag_stab_boost)}
        if diag_stab_boost
        else {}
    )
    # the fused native round reads the mesh's l2wt, so the scalar stab
    # retention (applied in map_data) composes with it unchanged
    fast_round = None if use_robust else getattr(energy, "spw_round", None)
    # big-SOC vets on the FINE mesh: its full aux diagonal is
    # round-invariant, compute it once outside the round loop
    big_soc_D = (
        energy.aux_diagonal(mesh)
        if big_soc and rounds > 1 and hasattr(energy, "transport")
        else None
    )
    for _round in range(rounds):
        if aaf is not None and n_cur <= aaf * n0:
            break
        cm = cur_active
        if max_agg is not None:
            cm = cm & (sizes * 2 <= max_agg)
        if not cm.any():
            break
        partner = None
        if fast_round is not None:
            # fused native soc + adjacency + handshake (H1: one C++ pass
            # instead of ~10 allocating O(ne) numpy passes per round)
            partner = fast_round(
                cur_mesh, theta, None if cm.all() else cm
            )
        if partner is None:
            soc = (
                _robust_soc_prefiltered(
                    energy, cur_mesh, rob_kw, scal_rel_thresh
                )
                if use_robust
                else energy.soc(cur_mesh)
            )
            S = cur_mesh.edge_graph(weights=soc)
            partner = handshake_match(S, theta, can_match=cm)
        if big_soc and _round >= 1 and hasattr(energy, "transport"):
            # agglomerate-wide acceptance (checkBigSOC, spw_agg.hpp:31,
            # !FIRST_ROUND like the reference): vet merged unions on the
            # FINE members before accepting the round's matches
            partner = big_soc_vet(
                energy,
                mesh,
                v2c,
                partner,
                theta if big_soc_rho is None else float(big_soc_rho),
                Dfull=big_soc_D,
            )
        c2agg, n_agg = aggregates_from_partner(partner, cur_active)
        if n_agg >= n_cur or n_agg == 0:
            break
        mask = v2c >= 0
        v2c[mask] = c2agg[v2c[mask]]
        act = c2agg >= 0
        sizes = np.bincount(
            c2agg[act], weights=sizes[act].astype(np.float64),
            minlength=n_agg,
        ).astype(np.int64)
        coarse_edges, e2ce = map_edges(cur_mesh, c2agg, n_agg)
        cur_mesh = energy.map_data(
            cur_mesh, c2agg, n_agg, coarse_edges, e2ce, **map_kw
        )
        cur_active = np.ones(n_agg, dtype=bool)
        n_cur = n_agg
    if adopt_orphans and n_cur:
        soc = (
            _robust_soc_prefiltered(
                energy, cur_mesh, rob_kw, scal_rel_thresh
            )
            if use_robust
            else energy.soc(cur_mesh)
        )
        S_c = cur_mesh.edge_graph(weights=soc)
        v2c, n_cur = _adopt_orphans(S_c, v2c, n_cur)
    return v2c, n_cur


def _robust_soc_prefiltered(energy, mesh, rob_kw, rel: float):
    """Robust SOC with the reference's scalar phase-(a) neighbor filter.

    `FindNeib3Step` (spw_agg_impl.hpp:677-711) computes the cheap scalar
    weight for ALL neighbors, then robust-scores only those clearing
    ``scalRelThresh * maxScalWt`` (relative to the picking vertex's row
    maximum; default 0.25, spw_agg_impl.hpp:1404) and sets the rest to
    -1 (excluded). The symmetric-handshake counterpart: an edge is
    shortlisted when it clears the threshold for EITHER endpoint; only
    shortlisted edges pay the pencil EVP, the rest score 0 (never
    proposed). ``rel <= 0`` disables the filter.
    """
    if rel <= 0 or "neib_boost" in rob_kw:
        # neighbor-boost accumulates path energies mesh-wide; keep the
        # full scoring there (the boost already changes every pencil)
        return energy.soc_robust(mesh, **rob_kw)
    w = energy.soc(mesh)
    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    rowmax = np.zeros(mesh.nv)
    np.maximum.at(rowmax, i, w)
    np.maximum.at(rowmax, j, w)
    keep = (w >= rel * rowmax[i]) | (w >= rel * rowmax[j])
    if keep.all():
        return energy.soc_robust(mesh, **rob_kw)
    return energy.soc_robust(mesh, edge_subset=keep, **rob_kw)


def _adopt_orphans(S_c, v2c, n_c):
    """Merge singleton coarse vertices into their strongest neighbor agg.

    The reference runs a final adoption round for orphans
    (spw_agg_impl.hpp, final round with `allrobust` pick). Here: coarse
    vertices representing a single fine vertex join their strongest coarse
    neighbor (if any), then indices are re-compacted.
    """
    sizes = np.bincount(v2c[v2c >= 0], minlength=n_c)
    orphan = sizes == 1
    if not orphan.any():
        return v2c, n_c
    best, bv = csr_rowwise_argmax(S_c.indptr, S_c.indices, S_c.data)
    # redirect orphans with a neighbor; avoid chains: only adopt into
    # non-orphan aggregates
    tgt = np.arange(n_c)
    ok = orphan & (best >= 0) & ~orphan[np.clip(best, 0, n_c - 1)]
    tgt[ok] = best[ok]
    # O(n) compaction: surviving ids = set(tgt); every survivor is its own
    # target, so numbering survivors ascending reproduces np.unique's order
    keep = np.zeros(n_c, dtype=bool)
    keep[tgt] = True
    newid = np.cumsum(keep) - 1
    out = v2c.copy()
    m = out >= 0
    out[m] = newid[tgt[out[m]]]
    return out, int(keep.sum())


def plate_test_aggregate(coords: np.ndarray, active=None, nz: int = 0):
    """Debug coarsener: aggregate along the last coordinate axis.

    JAX stand-in for `PlateTestAgglomerator`
    (src/base/coarsening/plate_test_agg.hpp:14-30): all vertices sharing the
    same (x, y) column form one aggregate.
    """
    n = len(coords)
    if active is None:
        active = np.ones(n, dtype=bool)
    key = np.round(coords[:, :-1] * 1e8).astype(np.int64)
    keys = key[:, 0] if key.shape[1] == 1 else key[:, 0] * (2**31) + key[:, 1]
    v2agg = np.full(n, -1, dtype=np.int64)
    act = np.flatnonzero(active)
    uniq, inv = np.unique(keys[act], return_inverse=True)
    v2agg[act] = inv
    return v2agg, len(uniq)
