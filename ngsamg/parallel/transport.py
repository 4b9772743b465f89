"""Transport interface: the distributed setup's communication boundary.

The reference reaches every process boundary through three MPI shapes —
indexed fetches from owners (mpiwrap_extension.hpp:17 typed gathers),
owner-routed reductions (reducetable.hpp:22 gather-reduce-scatter), and
routed sparse-row shipping (grid_contract.hpp:144-182) — and the setup in
`parallel/dist_setup.py` (+ dist_elast/dist_stokes) funnels ALL cross-shard
data movement through four primitives with exactly those shapes:

* ``gather(parts, starts, idx)``        — values at global indices from owners
* ``reduce_by_owner(starts, idx, v, n)``— sum contributions onto owners
* ``route_coo(starts, ri, cj, vv, nc)`` — COO triples to their row owners
* ``gather_csr_rows(parts, starts, r)`` — sparse rows from their owners

This module puts those primitives behind a :class:`Transport` interface with
two implementations (a third, true multi-process one lives in
``parallel/mp_runtime.py``):

* :class:`LocalTransport` — single-controller numpy index movement (the
  production default on this one-host infrastructure; zero overhead).
* :class:`CollectiveTransport` — every exchange runs as a jitted
  ``jax.shard_map`` program over a device ``Mesh`` whose one inter-device
  op is ``lax.all_to_all``: payloads are bucket-padded per (source, dest)
  pair, moved device-to-device, unpacked on the destination shard. This is
  the collective program a multi-controller run executes; on the virtual CPU
  mesh it validates that the setup's entire communication pattern lowers
  to XLA collectives with O(routed items) volume.
* ``mp_runtime.MPTransport`` — one spawned OS process per shard (separate
  address spaces, pipe-mesh message passing): the execution model of the
  reference's MPI ranks, run by the same rank-local level loop via
  :meth:`Transport.my_shards`.

Payloads cross the device boundary bit-cast to uint32 words so f64/i64
values round-trip EXACTLY regardless of the process's x64 mode — the
collective-transport hierarchy is bitwise-identical to the local one
(asserted by tests/test_dist_setup.py::test_collective_transport_parity).
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import scipy.sparse as sp

__all__ = [
    "Transport",
    "LocalTransport",
    "CollectiveTransport",
    "get_transport",
    "use_transport",
    "shard_nbytes",
]


def _owner(starts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return np.searchsorted(starts, idx, side="right") - 1


def shard_nbytes(*objs) -> int:
    """Resident bytes of one shard's numpy/scipy state (peak-memory probe)."""
    total = 0
    for o in objs:
        if o is None:
            continue
        if sp.issparse(o):
            for a in (
                getattr(o, "data", None),
                getattr(o, "indices", None),
                getattr(o, "indptr", None),
            ):
                if a is not None:
                    total += a.nbytes
        elif isinstance(o, np.ndarray):
            total += o.nbytes
        elif isinstance(o, (list, tuple)):
            total += shard_nbytes(*o)
    return total


class Transport:
    """Abstract communication boundary (one method per MPI shape).

    Single-controller transports (Local, Collective) own every shard:
    ``my_shards`` is ``range(n)`` and the replicated-metadata collectives
    (``allgather``/``allgather_parts``/``allreduce_any``) are identities —
    the caller already computed the global quantity. A true
    multi-controller transport (``mp_runtime.MPTransport``: one OS process
    per shard) overrides them with real message passing; setup code that
    iterates ``for s in transport.my_shards(n)`` and funnels every
    cross-shard access through the primitives runs unchanged under both.
    """

    name = "abstract"

    def my_shards(self, n_shards: int):
        """The shard indices THIS controller computes (all, by default)."""
        return range(n_shards)

    def gather(
        self, parts: list, starts: np.ndarray, idx: np.ndarray
    ) -> np.ndarray:
        raise NotImplementedError

    def reduce_by_owner(
        self, starts: np.ndarray, idx: np.ndarray, vals: np.ndarray,
        n_local: list,
    ) -> list:
        raise NotImplementedError

    def route_coo(self, starts_row, ri, cj, vv, ncols) -> list:
        raise NotImplementedError

    def route_rows(self, starts, idx, arrays: tuple) -> list:
        """Route aligned item rows to the owner shard of ``idx[i]``.

        ``arrays`` are item-aligned: row ``i`` of every array describes one
        item that must land on ``owner(idx[i])``. Returns a per-shard list
        (``None`` in slots owned elsewhere) of tuples of arrays holding the
        received items in DETERMINISTIC (source rank ascending, source
        position ascending) order — the order a single controller sees, so
        accumulations stay bitwise-reproducible across transports. The
        typed-table analog of the reference's ReduceTable routing
        (reducetable.hpp:22) for payloads that are not plain scalars
        (edge matrices, sort keys, weights).
        """
        raise NotImplementedError

    def gather_csr_rows(self, parts, starts, rows_g, ncols):
        raise NotImplementedError

    # -- replicated-metadata collectives (identity on one controller) ------
    def allgather(self, arr: np.ndarray) -> np.ndarray:
        """Concatenate each controller's contribution, rank order."""
        return np.asarray(arr)

    def allgather_parts(self, parts: list) -> np.ndarray:
        """Concatenate per-shard arrays (None for shards owned elsewhere)
        into the replicated global vector."""
        return np.concatenate([np.asarray(p) for p in parts if p is not None])

    def allreduce_any(self, flag: bool) -> bool:
        return bool(flag)


class LocalTransport(Transport):
    """Single-process numpy index movement (single-controller staging)."""

    name = "local"

    def gather(self, parts, starts, idx):
        first = np.asarray(parts[0])
        if len(idx) == 0:
            return np.empty((0,) + first.shape[1:], dtype=first.dtype)
        # ownerless indices would return uninitialized memory silently
        assert idx.min() >= 0 and idx.max() < starts[-1], "unowned index"
        own = _owner(starts, idx)
        out = np.empty((len(idx),) + first.shape[1:], dtype=first.dtype)
        for s in range(len(parts)):
            m = own == s
            if m.any():
                out[m] = np.asarray(parts[s])[idx[m] - starts[s]]
        return out

    def reduce_by_owner(self, starts, idx, vals, n_local):
        out = [np.zeros(nl, dtype=np.float64) for nl in n_local]
        own = _owner(starts, idx)
        for s in range(len(out)):
            m = own == s
            if m.any():
                np.add.at(out[s], idx[m] - starts[s], vals[m])
        return out

    def route_coo(self, starts_row, ri, cj, vv, ncols):
        n_shards = len(starts_row) - 1
        own = _owner(starts_row, ri)
        out = []
        for t in range(n_shards):
            nloc = int(starts_row[t + 1] - starts_row[t])
            m = own == t
            if m.any():
                M = sp.coo_matrix(
                    (vv[m], (ri[m] - starts_row[t], cj[m])),
                    shape=(nloc, ncols),
                ).tocsr()
                M.sum_duplicates()
            else:
                M = sp.csr_matrix((nloc, ncols))
            out.append(M)
        return out

    def route_rows(self, starts, idx, arrays):
        # caller supplies its owned shards' items concatenated in shard
        # order, so selecting by owner preserves (source, position) order
        n_shards = len(starts) - 1
        own = _owner(starts, np.asarray(idx, dtype=np.int64))
        out = []
        for t in range(n_shards):
            m = own == t
            out.append(tuple(a[m] for a in arrays))
        return out

    def gather_csr_rows(self, parts, starts, rows_g, ncols):
        own = _owner(starts, rows_g)
        blocks, order = [], []
        for s in range(len(parts)):
            m = own == s
            if m.any():
                blocks.append(parts[s][rows_g[m] - starts[s]])
                order.append(np.flatnonzero(m))
        if not blocks:
            return sp.csr_matrix((0, ncols))
        stacked = sp.vstack(blocks, format="csr")
        inv = np.argsort(np.concatenate(order), kind="stable")
        return stacked[inv]


def _bucket(n: int) -> int:
    """Next power of two (bounds the compiled-program count)."""
    return 1 if n <= 1 else 1 << int(n - 1).bit_length()


def _to_u32(a: np.ndarray) -> np.ndarray:
    """(m, ...) array -> (m, words) uint32 view-copy (exact bit transport).

    Sub-word dtypes (bool/int8/int16) widen to int32 words first."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize < 4:
        a = np.ascontiguousarray(a.astype(np.int32))
    m = a.shape[0]
    words = (a.dtype.itemsize * int(np.prod(a.shape[1:], initial=1))) // 4
    if m == 0:
        return np.zeros((0, max(words, 1)), dtype=np.uint32)
    return a.view(np.uint32).reshape(m, -1)


def _from_u32(w: np.ndarray, dtype, tail_shape) -> np.ndarray:
    m = w.shape[0]
    dtype = np.dtype(dtype)
    if dtype.itemsize < 4:
        out = np.ascontiguousarray(w).view(np.int32).astype(dtype)
    else:
        out = np.ascontiguousarray(w).view(dtype)
    return out.reshape((m,) + tuple(tail_shape))


class CollectiveTransport(Transport):
    """Exchanges executed as lax.all_to_all programs over a device mesh.

    Every primitive is built on one collective: ``_exchange(dest, bufs)``
    routes items (uint32 word rows) to destination shards with a single
    all_to_all per call. gather/gather_csr_rows are two-phase — requests
    routed to owners, replies routed back — matching the reference's
    request/reply DCC exchanges (dcc_map.hpp:20-134). Per-(src,dest) slots
    are padded to a power-of-two cap, so the number of distinct compiled
    programs stays O(log max-message-size) per word width.

    Single-controller stand-in for source attribution: items that live on
    the controller (concatenated call sites) are attributed to source
    shards by their position; the device-to-device movement is identical
    for any attribution.
    """

    name = "collective"

    def __init__(self, mesh=None, axis_name: str = "shards"):
        import jax

        if mesh is None:
            from .shard import make_mesh

            mesh = make_mesh(len(jax.devices()))
        self.mesh = mesh
        self.axis = mesh.axis_names[0] if mesh.axis_names else axis_name
        self.n = int(np.prod(mesh.devices.shape))
        self._progs: dict = {}
        self.calls = 0
        self.moved_words = 0

    # -- the one collective ------------------------------------------------
    def _prog(self, cap: int, widths: tuple):
        key = (cap, widths)
        fn = self._progs.get(key)
        if fn is not None:
            return fn
        import jax
        from jax import lax
        from jax.sharding import PartitionSpec as P

        ax, n = self.axis, self.n

        def run(*bufs):
            # each local block: (1, n, cap, w) — my rows for every dest
            out = []
            for b in bufs:
                r = lax.all_to_all(
                    b, ax, split_axis=1, concat_axis=0, tiled=False
                )
                # received: (n, 1, cap, w) = every source's slice for me
                out.append(r.reshape(1, n, cap, r.shape[-1]))
            return tuple(out)

        spec = P(ax, None, None, None)
        fn = jax.jit(
            jax.shard_map(
                run,
                mesh=self.mesh,
                in_specs=(spec,) * len(widths),
                out_specs=(spec,) * len(widths),
            )
        )
        self._progs[key] = fn
        return fn

    def _exchange(self, src, dest, arrays):
        """Route items to dest shards; returns (per-dest arrays, per-dest
        source-order positions). src gives each item's source shard."""
        n = self.n
        m = len(dest)
        pos = np.arange(m, dtype=np.int64)
        order = np.lexsort((pos, dest, src))
        s_src, s_dest = src[order], dest[order]
        counts = np.zeros((n, n), dtype=np.int64)
        np.add.at(counts, (s_src, s_dest), 1)
        cap = _bucket(int(counts.max()) if m else 1)
        # slot of each item inside its (src, dest) block
        blk = s_src * n + s_dest
        slot = pos - np.repeat(
            np.concatenate([[0], np.cumsum(np.bincount(blk, minlength=n * n))[:-1]]),
            np.bincount(blk, minlength=n * n),
        )
        u32s = [_to_u32(a[order]) for a in arrays]
        # position tag (original index) rides along so destinations can
        # re-order deliveries and address replies
        u32s.append(_to_u32(np.asarray(order, np.int64)))
        bufs = []
        for u in u32s:
            w = u.shape[1]
            buf = np.zeros((n, n, cap, w), dtype=np.uint32)
            buf[s_src, s_dest, slot] = u
            bufs.append(buf)
        vmask = np.zeros((n, n, cap), dtype=np.uint32)
        vmask[s_src, s_dest, slot] = 1
        bufs.append(vmask[..., None])
        import jax

        fn = self._prog(cap, tuple(b.shape[-1] for b in bufs))
        outs = fn(*bufs)
        outs = [np.asarray(jax.device_get(o)) for o in outs]
        self.calls += 1
        self.moved_words += sum(int(b.size) for b in bufs)
        valid = outs[-1][..., 0].astype(bool)  # (dest, src, cap)
        got_tag = outs[-2]
        per_dest_arrays, per_dest_pos = [], []
        for d in range(n):
            vm = valid[d]
            rows = [
                _from_u32(o[d][vm], a.dtype, np.shape(a)[1:])
                for o, a in zip(outs[:-2], arrays)
            ]
            tags = _from_u32(got_tag[d][vm], np.int64, ())
            # deterministic order: by original position
            ordr = np.argsort(tags, kind="stable")
            per_dest_arrays.append([r[ordr] for r in rows])
            per_dest_pos.append(tags[ordr])
        return per_dest_arrays, per_dest_pos

    def _even_src(self, m: int) -> np.ndarray:
        cuts = np.linspace(0, m, self.n + 1).astype(np.int64)
        return np.repeat(np.arange(self.n), np.diff(cuts))

    # -- primitives ---------------------------------------------------------
    def gather(self, parts, starts, idx):
        first = np.asarray(parts[0])
        if len(idx) == 0:
            return np.empty((0,) + first.shape[1:], dtype=first.dtype)
        assert idx.min() >= 0 and idx.max() < starts[-1], "unowned index"
        own = _owner(starts, idx)
        src = self._even_src(len(idx))
        # phase 1: requests (global index) to owners
        reqs, req_pos = self._exchange(src, own, (idx.astype(np.int64),))
        # owners look up locally, reply to the requesting shard
        rep_vals, rep_pos, rep_src = [], [], []
        for s in range(self.n):
            gi = reqs[s][0]
            vals = np.asarray(parts[s])[gi - starts[s]]
            rep_vals.append(vals)
            rep_pos.append(req_pos[s])
            rep_src.append(np.full(len(gi), s, dtype=np.int64))
        allv = np.concatenate(rep_vals)
        allp = np.concatenate(rep_pos)
        alls = np.concatenate(rep_src)
        back_dest = src[allp]
        # phase 2: replies (value, original position) back to requesters
        reps, _ = self._exchange(
            alls, back_dest, (allv, allp.astype(np.int64))
        )
        out = np.empty((len(idx),) + first.shape[1:], dtype=first.dtype)
        for d in range(self.n):
            vals, posn = reps[d]
            out[posn] = vals
        return out

    def reduce_by_owner(self, starts, idx, vals, n_local):
        own = _owner(starts, idx)
        src = self._even_src(len(idx))
        routed, _ = self._exchange(
            src, own, (idx.astype(np.int64), np.asarray(vals, np.float64))
        )
        out = []
        for s in range(self.n):
            acc = np.zeros(n_local[s], dtype=np.float64)
            gi, v = routed[s]
            np.add.at(acc, gi - starts[s], v)
            out.append(acc)
        return out

    def route_coo(self, starts_row, ri, cj, vv, ncols):
        n_shards = len(starts_row) - 1
        own = _owner(starts_row, ri)
        src = self._even_src(len(ri))
        routed, _ = self._exchange(
            src,
            own,
            (
                ri.astype(np.int64),
                cj.astype(np.int64),
                np.asarray(vv, np.float64),
            ),
        )
        out = []
        for t in range(n_shards):
            nloc = int(starts_row[t + 1] - starts_row[t])
            gi, gj, v = routed[t]
            if len(gi):
                M = sp.coo_matrix(
                    (v, (gi - starts_row[t], gj)), shape=(nloc, ncols)
                ).tocsr()
                M.sum_duplicates()
            else:
                M = sp.csr_matrix((nloc, ncols))
            out.append(M)
        return out

    def route_rows(self, starts, idx, arrays):
        idx = np.asarray(idx, dtype=np.int64)
        own = _owner(starts, idx)
        src = self._even_src(len(idx))
        # _exchange orders each destination's deliveries by original
        # position; with contiguous per-source position ranges that IS
        # (source rank, source position) order
        routed, _ = self._exchange(src, own, tuple(arrays))
        return [tuple(r) for r in routed]

    def gather_csr_rows(self, parts, starts, rows_g, ncols):
        if len(rows_g) == 0:
            return sp.csr_matrix((0, ncols))
        own = _owner(starts, rows_g)
        src = self._even_src(len(rows_g))
        reqs, req_pos = self._exchange(
            src, own, (rows_g.astype(np.int64),)
        )
        # owners flatten requested rows to (req position, col, val) items
        ri_l, cj_l, vv_l, src_l = [], [], [], []
        for s in range(self.n):
            gi = reqs[s][0]
            sub = parts[s][gi - starts[s]].tocoo()
            ri_l.append(req_pos[s][sub.row])
            cj_l.append(sub.col.astype(np.int64))
            vv_l.append(sub.data.astype(np.float64))
            src_l.append(np.full(sub.nnz, s, dtype=np.int64))
        allr = np.concatenate(ri_l)
        back_dest = src[allr] if len(allr) else np.zeros(0, np.int64)
        routed, _ = self._exchange(
            np.concatenate(src_l),
            back_dest,
            (allr, np.concatenate(cj_l), np.concatenate(vv_l)),
        )
        rr = np.concatenate([r[0] for r in routed])
        cc = np.concatenate([r[1] for r in routed])
        dd = np.concatenate([r[2] for r in routed])
        M = sp.coo_matrix(
            (dd, (rr, cc)), shape=(len(rows_g), ncols)
        ).tocsr()
        M.sum_duplicates()
        M.sort_indices()
        return M


_ACTIVE: list[Transport] = [LocalTransport()]


def get_transport() -> Transport:
    """The active transport (LocalTransport unless overridden)."""
    return _ACTIVE[-1]


@contextmanager
def use_transport(t: Transport):
    """Run distributed setups with `t` as the communication backend."""
    _ACTIVE.append(t)
    try:
        yield t
    finally:
        _ACTIVE.pop()
