"""Explicit halo-exchange SpMV over a device mesh (shard_map + ppermute).

JAX replacement for the reference's hybrid-matrix machinery: NgsAMG
splits each parallel matrix into owned + ghost couplings and overlaps
Gauss-Seidel with MPI halo exchange
(/root/reference/src/base/linalg/hybrid_matrix.hpp:28-144,
src/base/linalg/dcc_map.hpp:20-134, hybrid_base_smoother.hpp:56-61). Here
the same structure becomes: rows block-partitioned over a 1-D mesh axis,
each shard holding its contiguous row slice of a banded (DIA) operator;
matvec needs only a halo of `halo_width` entries from each neighbor, moved
with two `jax.lax.ppermute` shifts between devices, while the interior FMA work
proceeds on data already local.

This is the bandwidth-scalable alternative to the GSPMD all-gather path in
:mod:`ngsamg.parallel.shard`: communication volume is O(halo) instead of
O(n), exactly like the reference's interface-only DCC exchanges.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sparse.formats import DiaMatrix


def dia_halo_matvec(A: DiaMatrix, mesh: Mesh, axis: str = "rows"):
    """Build a shard_map'd matvec closure for a row-sharded DiaMatrix.

    The returned function maps (data_local, x_local) -> y_local under
    shard_map; `A.data` must be sharded (None, axis) and x (axis, None).
    Requires nrows_pad divisible by the mesh size and halo width (the max
    |offset|) not exceeding one shard.
    """
    nshards = mesh.devices.size
    n = A.nrows_pad
    assert n % nshards == 0
    local = n // nshards
    lo = max(0, -min(A.offsets))
    hi = max(0, max(A.offsets))
    if max(lo, hi) > local:
        raise ValueError("halo wider than one shard; replicate this level")
    offsets = A.offsets

    def body(data, x):
        # data: (ndiag, local); x: (local, 1)
        xf = x[:, 0]
        # halo exchange: left neighbor's tail and right neighbor's head.
        # ppermute cyclically; the wrap-around halo is masked off below.
        idx = jax.lax.axis_index(axis)
        right_src = [(i, (i + 1) % nshards) for i in range(nshards)]
        left_src = [((i + 1) % nshards, i) for i in range(nshards)]
        tail = jax.lax.ppermute(xf[-lo:], axis, right_src) if lo else None
        head = jax.lax.ppermute(xf[:hi], axis, left_src) if hi else None
        if tail is not None:
            tail = jnp.where(idx == 0, 0.0, tail)  # no left neighbor
        if head is not None:
            head = jnp.where(idx == nshards - 1, 0.0, head)
        parts = [p for p in (tail, xf, head) if p is not None]
        xp = jnp.concatenate(parts)
        y = jnp.zeros_like(xf)
        for d, off in enumerate(offsets):
            y = y + data[d] * jax.lax.dynamic_slice_in_dim(
                xp, lo + off, local
            )
        return y[:, None]

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis, None)),
        out_specs=P(axis, None),
    )
    return fn


def demo_sharded_solve(n_devices: int = 8, n: int = 24):
    """End-to-end check: halo-exchange DIA SpMV == replicated SpMV."""
    from ..sparse import formats
    from ..utils import fem

    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("rows",))
    p = fem.poisson_3d(n)
    A = formats.dia_from_scipy(p.A, jnp.float32, row_align=8 * n_devices)
    x = np.random.default_rng(0).standard_normal(A.nrows_pad)
    xs = jax.device_put(
        jnp.asarray(x[:, None], jnp.float32),
        NamedSharding(mesh, P("rows", None)),
    )
    data_s = jax.device_put(
        A.data, NamedSharding(mesh, P(None, "rows"))
    )
    fn = dia_halo_matvec(A, mesh)
    y = jax.jit(fn)(data_s, xs)
    ref = p.A @ x[: p.n]
    err = np.abs(np.asarray(y[: p.n, 0]) - ref).max() / np.abs(ref).max()
    return float(err)


# ---------------------------------------------------------------------------
# interface-halo SpMV for unstructured (tile-ELL) levels
# ---------------------------------------------------------------------------


def plan_tile_halo(cols: np.ndarray, nrows_pad: int, n_shards: int):
    """Owner/ghost split of a row-sharded TileELL's columns (host).

    The DCC-map analog (dcc_map.hpp:20-134) for unstructured levels: each
    shard owns a contiguous row block; columns outside it are GHOSTS.
    Every shard contributes its interface rows (the union of all other
    shards' ghost needs) to one padded all-gather buffer — communication
    is O(total interface), not O(n) as under the GSPMD all-gather of x.

    Returns (new_cols (T, K) int32 into [local_n + nsh*Smax),
             send_idx (n_shards, Smax) int32 LOCAL row indices, Smax).
    """
    T, K = cols.shape
    assert nrows_pad % n_shards == 0 and T % n_shards == 0
    local = nrows_pad // n_shards
    Tl = T // n_shards
    owner = (cols // local).astype(np.int64)
    # single sort/unique pass over (owner, col) pairs: ghost entries are
    # slots whose column's owner differs from the reading shard
    reader = np.repeat(
        np.arange(T, dtype=np.int64) // Tl, K
    )
    flat_c = cols.ravel().astype(np.int64)
    flat_o = owner.ravel()
    gh_flat = flat_o != reader
    keys = np.unique(flat_o[gh_flat] * np.int64(nrows_pad) + flat_c[gh_flat])
    key_owner = keys // nrows_pad
    key_col = keys % nrows_pad
    counts = np.bincount(key_owner, minlength=n_shards)
    starts = np.concatenate([[0], np.cumsum(counts)])
    Smax = max(int(counts.max(initial=0)), 1)
    send_idx = np.zeros((n_shards, Smax), dtype=np.int32)
    for t in range(n_shards):
        lst = key_col[starts[t]:starts[t + 1]]
        send_idx[t, : len(lst)] = (lst - t * local).astype(np.int32)
    # remap columns: local -> [0, local); ghost g owned by t at position
    # p within owner t's (sorted) send list -> local + t*Smax + p
    new_cols = (flat_c - flat_o * local).astype(np.int64)
    if gh_flat.any():
        pos = np.searchsorted(keys, flat_o[gh_flat] * np.int64(nrows_pad)
                              + flat_c[gh_flat])
        new_cols[gh_flat] = (
            local + flat_o[gh_flat] * Smax + (pos - starts[flat_o[gh_flat]])
        )
    return (
        new_cols.reshape(T, K).astype(np.int32), send_idx, int(Smax)
    )


from dataclasses import dataclass
from functools import partial


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "cols", "send", "gtile", "gdata", "gcol"],
    meta_fields=[
        "mesh", "axes", "nrows", "nrows_pad", "ncols_pad", "tile_m",
        "smax", "nsh", "gmax",
    ],
)
@dataclass(frozen=True)
class HaloTileELL:
    """Row-sharded TileELL whose matvec is a shard_map with
    INTERFACE-ONLY exchange — the production-cycle form of
    :func:`tile_halo_matvec`.

    The matvec is the M+G SPLIT of the reference's hybrid matrix
    (hybrid_matrix.hpp:28-144) with its 3-stage overlap structure
    (hybrid_base_smoother.hpp:56-61): ``data``/``cols`` hold the
    INTERIOR part M (ghost slots zeroed, columns all local), applied as
    a product that does NOT depend on the collective — XLA's latency-
    hiding scheduler can run the interface all-gather concurrently —
    and the G part is a compact per-ghost-slot correction
    (``gtile``/``gdata``/``gcol``) applied from the gathered buffer
    afterwards. Communication per apply is ``nsh * smax`` gathered
    scalars — O(interface), not O(n) like the GSPMD all-gather of x.
    Built by `parallel/shard.py::shard_operator` for fully-row-sharded
    TileELL levels.
    """

    data: jax.Array  # (T, K, M) INTERIOR part, ghost slots zeroed
    cols: jax.Array  # (T, K) int32, all < local (ghost slots -> 0)
    send: jax.Array  # (nsh, smax) int32 local rows, sharded P(axes, None)
    gtile: jax.Array  # (nsh, gmax) int32 LOCAL tile of each ghost slot
    gdata: jax.Array  # (nsh, gmax, M) ghost-slot matrix data
    gcol: jax.Array  # (nsh, gmax) int32 index into the gathered buffer
    mesh: Mesh
    axes: tuple  # mesh axis names the rows are sharded over
    nrows: int
    nrows_pad: int
    ncols_pad: int
    tile_m: int
    smax: int
    nsh: int
    gmax: int

    @property
    def shape(self):
        return self.nrows, self.ncols_pad

    @property
    def comm_per_apply(self) -> int:
        """Gathered scalars per matvec (the O(interface) volume)."""
        return self.nsh * self.smax

    def halo_matvec(self, x: jax.Array) -> jax.Array:
        def body(data, cols_l, send_l, gt, gd, gc, xl):
            xf = xl[:, 0]
            xs = xf[send_l[0]]  # (smax,) this shard's interface values
            # issue the collective FIRST; the interior product below has
            # no data dependence on it (3-stage overlap structure)
            buf = jax.lax.all_gather(xs, self.axes)
            g = xf[cols_l]  # (Tl, K) all-local gather
            y = jnp.einsum(
                "tkm,tk->tm", data, g,
                preferred_element_type=data.dtype,
            )
            # interface correction: each ghost slot contributes its
            # (M,) data row scaled by one gathered scalar
            buff = buf.reshape(-1)
            contrib = gd[0] * buff[gc[0]][:, None]  # (gmax, M)
            y = y.at[gt[0]].add(contrib)
            return y.reshape(-1, 1)

        ax = self.axes
        fn = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=(
                P(ax, None, None), P(ax, None), P(ax, None),
                P(ax, None), P(ax, None, None), P(ax, None),
                P(ax, None),
            ),
            out_specs=P(ax, None),
            check_vma=False,
        )
        return fn(
            self.data, self.cols, self.send,
            self.gtile, self.gdata, self.gcol, x,
        )[: self.nrows_pad]

    def __matmul__(self, x):
        return self.halo_matvec(x)


def _ghost_split(new_cols, data, send_shape_local, nsh, Tl, local):
    """Extract the G (ghost) part per shard: per ghost slot its local
    tile, its data row(s), and its gathered-buffer index; zero the slot
    out of the interior arrays. Returns (cols_own, data_own,
    gtile (nsh, gmax), gdata (nsh, gmax, ...), gcol (nsh, gmax))."""
    T, K = new_cols.shape
    gh = new_cols >= local
    counts = [int(gh[s * Tl:(s + 1) * Tl].sum()) for s in range(nsh)]
    gmax = max(max(counts), 1)
    tail = data.shape[2:]
    gtile = np.zeros((nsh, gmax), dtype=np.int32)
    gdata = np.zeros((nsh, gmax) + tail, dtype=data.dtype)
    gcol = np.zeros((nsh, gmax), dtype=np.int32)
    data_own = data.copy()
    cols_own = new_cols.copy()
    for s in range(nsh):
        sl = slice(s * Tl, (s + 1) * Tl)
        t, k = np.nonzero(gh[sl])
        m = len(t)
        gtile[s, :m] = t.astype(np.int32)
        gdata[s, :m] = data[sl][t, k]
        gcol[s, :m] = (new_cols[sl][t, k] - local).astype(np.int32)
        data_own[sl][t, k] = 0
        cols_own[sl][t, k] = 0
    return cols_own, data_own, gtile, gdata, gcol, gmax


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "cols", "send", "gtile", "gdata", "gcol"],
    meta_fields=[
        "mesh", "axes", "nrows", "nrows_pad", "ncols_pad",
        "block_shape", "col_chunk", "smax", "nsh", "gmax",
    ],
)
@dataclass(frozen=True)
class HaloBlockELL:
    """Row-sharded BlockELL with INTERFACE-ONLY exchange — the block-
    format hybrid matrix (hybrid_matrix.hpp:28-144 covers every block
    size; round 4 only gave scalar TileELL levels this structure, so
    sharded elasticity paid GSPMD O(n) all-gathers).

    Each shard holds its contiguous BLOCK rows; ``cols`` are remapped to
    [0, local) for owned block columns and [local, local + nsh*smax)
    for ghost slots; ``send`` lists the interface block rows each shard
    contributes to one padded all-gather of (smax, bs) slabs.
    Communication per apply is ``nsh * smax * bs`` scalars —
    O(interface). Built by `parallel/shard.shard_operator` for fully
    row-sharded BlockELL levels; the cycle reaches it through the
    duck-typed ``halo_matvec`` hook in sparse/formats.matvec.
    """

    data: jax.Array  # (n_pad, K, br, bc) INTERIOR part, ghost slots zeroed
    cols: jax.Array  # (n_pad, K) int32, all < local (ghost slots -> 0)
    send: jax.Array  # (nsh, smax) int32 LOCAL block-row indices
    gtile: jax.Array  # (nsh, gmax) int32 LOCAL block row per ghost slot
    gdata: jax.Array  # (nsh, gmax, br, bc) ghost-slot blocks
    gcol: jax.Array  # (nsh, gmax) int32 index into the gathered buffer
    mesh: Mesh
    axes: tuple
    nrows: int  # logical block rows
    nrows_pad: int
    ncols_pad: int
    block_shape: tuple
    col_chunk: int
    smax: int
    nsh: int
    gmax: int

    @property
    def shape(self) -> tuple[int, int]:
        br, bc = self.block_shape
        return self.nrows * br, self.ncols_pad * bc

    @property
    def comm_per_apply(self) -> int:
        """Gathered scalars per matvec (the O(interface) volume)."""
        return self.nsh * self.smax * self.block_shape[1]

    def halo_matvec(self, x: jax.Array) -> jax.Array:
        def body(data, cols_l, send_l, gt, gd, gc, xl):
            xs = xl[send_l[0]]  # (smax, bc) interface block rows
            # collective first; the interior product is independent
            # (M+G 3-stage overlap, hybrid_base_smoother.hpp:56-61)
            buf = jax.lax.all_gather(xs, self.axes)  # (nsh, smax, bc)
            g = xl[cols_l]  # (nl, K, bc) all-local gather
            y = jnp.einsum(
                "nkij,nkj->ni", data, g,
                preferred_element_type=data.dtype,
            )
            bufr = buf.reshape(-1, xl.shape[1])
            xg = bufr[gc[0]]  # (gmax, bc)
            contrib = jnp.einsum(
                "gij,gj->gi", gd[0], xg,
                preferred_element_type=gd.dtype,
            )
            y = y.at[gt[0]].add(contrib)
            return y

        ax = self.axes
        fn = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=(
                P(ax, None, None, None), P(ax, None), P(ax, None),
                P(ax, None), P(ax, None, None, None), P(ax, None),
                P(ax, None),
            ),
            out_specs=P(ax, None),
            check_vma=False,
        )
        return fn(
            self.data, self.cols, self.send,
            self.gtile, self.gdata, self.gcol, x,
        )[: self.nrows_pad]

    def __matmul__(self, x):
        return self.halo_matvec(x)


def halo_block_ell(A, mesh: Mesh, axes: tuple) -> "HaloBlockELL":
    """Build a :class:`HaloBlockELL` from a (host-readable) BlockELL.

    Reuses :func:`plan_tile_halo` in BLOCK space: the column index space
    of a square BlockELL is its block-row space, so the owner/ghost
    split and send lists apply unchanged with "tile" = block row.
    """
    nsh = int(
        np.prod(
            [dict(zip(mesh.axis_names, mesh.devices.shape))[a] for a in axes]
        )
    )
    if A.col_chunk != 1:
        raise ValueError("halo_block_ell requires col_chunk == 1")
    cols = np.asarray(A.cols)
    n_pad = cols.shape[0]
    new_cols, send_idx, smax = plan_tile_halo(cols, n_pad, nsh)
    local = n_pad // nsh
    cols_own, data_own, gtile, gdata, gcol, gmax = _ghost_split(
        new_cols, np.asarray(A.data), None, nsh, local, local
    )
    sh4 = NamedSharding(mesh, P(axes, None, None, None))
    sh2 = NamedSharding(mesh, P(axes, None))
    return HaloBlockELL(
        data=jax.device_put(data_own, sh4),
        cols=jax.device_put(cols_own, sh2),
        send=jax.device_put(send_idx, sh2),
        gtile=jax.device_put(gtile, sh2),
        gdata=jax.device_put(gdata, sh4),
        gcol=jax.device_put(gcol, sh2),
        mesh=mesh,
        axes=tuple(axes),
        nrows=A.nrows,
        nrows_pad=n_pad,
        ncols_pad=n_pad,  # square sharded levels: x pads like the rows
        block_shape=A.block_shape,
        col_chunk=1,
        smax=smax,
        nsh=nsh,
        gmax=gmax,
    )


def halo_tile_ell(A, mesh: Mesh, axes: tuple) -> HaloTileELL:
    """Build a :class:`HaloTileELL` from a (host-readable) TileELL.

    ``axes`` are the mesh axis names whose product is the row-shard
    count. Pulls ``A.cols`` to host for the one-time plan — multi-chip
    placement happens from the controller, where the arrays are staged.
    """
    nsh = int(
        np.prod(
            [dict(zip(mesh.axis_names, mesh.devices.shape))[a] for a in axes]
        )
    )
    cols = np.asarray(A.cols)
    new_cols, send_idx, smax = plan_tile_halo(cols, A.nrows_pad, nsh)
    T = cols.shape[0]
    local = A.nrows_pad // nsh
    cols_own, data_own, gtile, gdata, gcol, gmax = _ghost_split(
        new_cols, np.asarray(A.data), None, nsh, T // nsh, local
    )
    sh3 = NamedSharding(mesh, P(axes, None, None))
    sh2 = NamedSharding(mesh, P(axes, None))
    return HaloTileELL(
        data=jax.device_put(data_own, sh3),
        cols=jax.device_put(cols_own, sh2),
        send=jax.device_put(send_idx, sh2),
        gtile=jax.device_put(gtile, sh2),
        gdata=jax.device_put(gdata, sh3),
        gcol=jax.device_put(gcol, sh2),
        mesh=mesh,
        axes=tuple(axes),
        nrows=A.nrows,
        nrows_pad=A.nrows_pad,
        ncols_pad=A.ncols_pad,
        tile_m=A.tile_m,
        smax=smax,
        nsh=nsh,
        gmax=gmax,
    )


def tile_halo_matvec(A, mesh: Mesh, axis: str = "rows"):
    """shard_map'd TileELL matvec with interface-only exchange.

    Returns (fn, data_sharded, cols_sharded, send_sharded, comm_per_apply)
    where fn(data, cols, send, x) -> y under the mesh, and comm_per_apply
    is the gathered element count (n_shards * Smax) — O(interface).
    """
    nsh = mesh.devices.size
    cols = np.asarray(A.cols)
    new_cols, send_idx, Smax = plan_tile_halo(cols, A.nrows_pad, nsh)
    local = A.nrows_pad // nsh

    def body(data, cols_l, send_l, x):
        xf = x[:, 0]
        xs = xf[send_l[0]]  # (Smax,) this shard's interface values
        buf = jax.lax.all_gather(xs, axis)  # (nsh, Smax)
        xp = jnp.concatenate([xf, buf.reshape(-1)])
        g = xp[cols_l]  # (Tl, K)
        y = jnp.einsum(
            "tkm,tk->tm", data, g,
            preferred_element_type=data.dtype,
        )
        return y.reshape(-1, 1)[:local]

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis, None), P(axis, None)),
        out_specs=P(axis, None),
    )
    sh_rows = NamedSharding(mesh, P(axis))
    sh_rows2 = NamedSharding(mesh, P(axis, None))
    data_s = jax.device_put(np.asarray(A.data), sh_rows)
    cols_s = jax.device_put(new_cols, sh_rows)
    send_s = jax.device_put(send_idx, sh_rows2)
    return fn, data_s, cols_s, send_s, nsh * Smax
