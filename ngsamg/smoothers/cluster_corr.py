"""Local cluster correction: exact solves on near-singular strong clusters.

Low-quality unstructured meshes (sliver tets, near-degenerate elements)
produce small vertex clusters whose local stiffness block is nearly
rank-deficient with an OSCILLATORY near-kernel (mixed-sign couplings of
comparable magnitude — e.g. a 4-vertex sliver cluster with couplings
(+1.75, -1.76, -1.17, +1.76) has a rank-2-deficient local block whose
kernel vectors alternate sign). A one-vector-per-aggregate coarse space
cannot represent such modes and point smoothers barely damp them, so a
handful of sliver clusters pins lambda_min of the preconditioned operator
(measured: 0.024 at 104k DoF, 36 PCG iterations vs 14 with this
correction).

The reference handles the same regime with dynamic block smoothers
(/root/reference/src/base/linalg/dyn_block_smoother.hpp:16,
dyn_block.hpp:14-109) that fuse strongly coupled rows into blocks solved
exactly. The JAX counterpart implemented here keeps the cheap
smoother (Chebyshev/GS) and ADDS a batched dense local solve on only the
defective clusters, applied multiplicatively and symmetrically around the
multigrid cycle:

    z  = C b                      (batched (K,K) solves)
    z += V(b - A z)               (the usual AMG cycle)
    z += C (b - A z)

Detection (host, setup phase): connected components of the
magnitude-strength graph |a_ij| >= beta * sqrt(a_ii a_jj), keep components
of size 2..max_size whose local block has lambda_min < eig_ratio *
max(diag). Application (device): one gather, one batched (ncl,K,K) x
(ncl,K) matmul, one scatter-add — static shapes, fuses into the jitted
solve step.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["idx", "inv"],
    meta_fields=[],
)
@dataclass(frozen=True)
class ClusterCorrection:
    """Device data: padded cluster row indices + dense local inverses.

    ``idx`` (ncl, K) int32, padded slots point at row 0 with the matching
    ``inv`` rows/cols zeroed so padded contributions vanish.
    """

    idx: jax.Array  # (ncl, K) int32
    inv: jax.Array  # (ncl, K, K) dtype


def _finish(blocks, members, csz, eig_ratio, dtype):
    """Shared tail: pad diag, min-eig filter, batched inverse, idx table.

    ``blocks`` (ncl,K,K) f64 with zeros outside each cluster's real
    (csz x csz) corner, ``members`` (ncl,K) int32 padded with 0.
    """
    ncl, K, _ = blocks.shape
    if ncl == 0:
        return None
    ii = np.arange(K)
    diag = blocks[:, ii, ii]
    maxdiag = np.maximum(diag.max(axis=1), 1e-300)
    padmask = ii[None, :] >= csz[:, None]
    blocks[:, ii, ii] = np.where(padmask, maxdiag[:, None], diag)
    wmin = np.linalg.eigvalsh(blocks)[:, 0]
    keep = wmin < eig_ratio * maxdiag
    if not keep.any():
        return None
    blocks = blocks[keep]
    padmask = padmask[keep]
    inv = np.linalg.inv(blocks)
    inv[np.broadcast_to(padmask[:, :, None], inv.shape)] = 0.0
    inv[np.broadcast_to(padmask[:, None, :], inv.shape)] = 0.0
    idx = members[keep].astype(np.int32)
    idx[padmask] = 0  # contribution is zero (inv rows/cols zeroed)
    return ClusterCorrection(idx=idx, inv=inv.astype(dtype))


def detect_clusters(
    A: sp.spmatrix,
    *,
    beta: float = 0.35,
    eig_ratio: float = 0.3,
    max_size: int = 16,
    dtype=np.float32,
) -> ClusterCorrection | None:
    """Find near-singular strong clusters of a scalar SPD matrix (host).

    Returns None when no defective cluster exists (e.g. on any
    shape-regular mesh) — the correction then costs nothing.
    """
    A = A.tocsr()
    n = A.shape[0]
    if n == 0:
        return None
    from ..native import cluster_detect as _nat_detect

    nat = _nat_detect(A, beta, eig_ratio, max_size)
    if nat is not None:
        blocks, members, csz = nat
        return _finish(
            blocks, members, csz.astype(np.int64), eig_ratio, dtype
        )
    d = A.diagonal()
    coo = A.tocoo()
    off = coo.row != coo.col
    r, c, v = coo.row[off], coo.col[off], coo.data[off]
    dpos = np.maximum(d, 1e-300)
    strong = np.abs(v) >= beta * np.sqrt(dpos[r] * dpos[c])
    if not strong.any():
        return None
    import scipy.sparse.csgraph as csg

    G = sp.coo_matrix(
        (np.ones(int(strong.sum())), (r[strong], c[strong])), shape=(n, n)
    ).tocsr()
    ncomp, lab = csg.connected_components(G, directed=False)
    sizes = np.bincount(lab, minlength=ncomp)
    elig = (sizes >= 2) & (sizes <= max_size)
    if not elig.any():
        return None
    # cluster id (contiguous) + slot within cluster, -1 for non-members
    cid = np.full(ncomp, -1, dtype=np.int64)
    cid[elig] = np.arange(int(elig.sum()))
    ncl = int(elig.sum())
    vcid = cid[lab]  # per-vertex cluster id or -1
    member = vcid >= 0
    order = np.lexsort((np.arange(n), np.where(member, vcid, ncl)))
    memb_sorted = order[: int(member.sum())]
    # slot: position within its cluster (lexsort keeps vertex order)
    cl_of = vcid[memb_sorted]
    starts = np.searchsorted(cl_of, np.arange(ncl + 1))
    slot = np.arange(len(memb_sorted)) - starts[cl_of]
    vslot = np.full(n, -1, dtype=np.int64)
    vslot[memb_sorted] = slot
    K = int(sizes[elig].max())

    # dense local blocks: all A entries with both ends in the same cluster
    blocks = np.zeros((ncl, K, K))
    both = member[coo.row] & member[coo.col] & (vcid[coo.row] == vcid[coo.col])
    br, bc, bv = coo.row[both], coo.col[both], coo.data[both]
    blocks[vcid[br], vslot[br], vslot[bc]] = bv
    members = np.zeros((ncl, K), dtype=np.int32)
    members[cl_of, slot] = memb_sorted.astype(np.int32)
    # numpy leaves: the caller batches the whole operator into ONE
    # device_put
    return _finish(blocks, members, sizes[elig], eig_ratio, dtype)


def cluster_apply(cc: ClusterCorrection, r: jax.Array) -> jax.Array:
    """z = C r: batched dense solves scattered back (scalar vectors).

    ``r`` is the padded (nrows_pad, 1) residual; returns same shape.
    """
    g = r[cc.idx, 0]  # (ncl, K)
    y = jnp.einsum(
        "ckj,cj->ck", cc.inv, g, preferred_element_type=r.dtype
    )
    out = jnp.zeros_like(r)
    return out.at[cc.idx.reshape(-1), 0].add(y.reshape(-1))
