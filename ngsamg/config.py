"""Typed, layered configuration for the AMG framework.

Mirrors the reference's option system (NgsAMG `BaseAMGPC::Options`,
/root/reference/src/base/precond/amg_pc.hpp:30-111 and
`BaseAMGFactory::Options`, src/base/factory/base_factory.hpp:88-207) as plain
dataclasses, including the per-level override idiom `SpecOpt<T>`
(src/base/utils/SpecOpt.hpp:16-80): an option has a default value plus an
optional per-level array; `get(level)` returns ``spec[level]`` when the level
is inside the array and the default otherwise.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Generic, Sequence, TypeVar, Union

T = TypeVar("T")


class SpecOpt(Generic[T]):
    """Default value + optional per-level overrides.

    Semantics match SpecOpt::GetOpt (SpecOpt.hpp:64):
    ``GetOpt(level) = spec[level] if level < len(spec) else default``.
    """

    __slots__ = ("default", "spec")

    def __init__(self, default: T, spec: Sequence[T] = ()):  # noqa: D107
        self.default = default
        self.spec = tuple(spec)

    def get(self, level: int) -> T:
        if 0 <= level < len(self.spec):
            return self.spec[level]
        return self.default

    def __repr__(self) -> str:
        if self.spec:
            return f"SpecOpt({self.default!r}, spec={list(self.spec)!r})"
        return f"SpecOpt({self.default!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, SpecOpt):
            return self.default == other.default and self.spec == other.spec
        return NotImplemented


SpecLike = Union[T, SpecOpt]


def as_spec(v: SpecLike) -> SpecOpt:
    """Accept either a bare value (default only) or a SpecOpt."""
    return v if isinstance(v, SpecOpt) else SpecOpt(v)


class CycleType(str, enum.Enum):
    """Multigrid cycle (amg_pc.hpp:44 `mg_cycle`: V/W/BS)."""

    V = "V"
    W = "W"
    BS = "BS"


class CoarseSolveType(str, enum.Enum):
    """Coarsest-level treatment (amg_pc.hpp:46-52 `clev`/`cinv_type`)."""

    INV = "inv"  # dense (pseudo-)inverse applied on device
    SMOOTH = "smooth"  # just smooth on the coarsest level
    NONE = "none"


class SmootherType(str, enum.Enum):
    """Per-level smoother choice (amg_pc.hpp:56-66 `sm_type`).

    The reference's sequential Gauss-Seidel ("gs") maps to multicolor block
    Gauss-Seidel on the device; "jacobi" maps to damped block-Jacobi;
    additional options: l1-Jacobi and Chebyshev (polynomial) smoothing.
    """

    GS = "gs"  # multicolor block Gauss-Seidel
    JACOBI = "jacobi"  # damped block Jacobi
    L1_JACOBI = "l1_jacobi"  # l1-scaled Jacobi (provably convergent)
    CHEBYSHEV = "chebyshev"  # Chebyshev polynomial smoother
    HIPTMAIR = "hiptmair"  # two-space smoother (Stokes)
    DYNBGS = "dyn_bgs"  # dyn-block GS (structural row fusion, dyn_block.hpp)


class CoarsenType(str, enum.Enum):
    """Coarsening algorithm (vertex_factory_impl.hpp:61 `crs_alg`)."""

    AUTO = "auto"  # lattice when coordinates form one, else SPW (default)
    SPW = "spw"  # successive pairwise matching (reference default)
    MIS = "mis"  # maximal-independent-set aggregation
    LATTICE = "lattice"  # DIA-preserving 2^d index-block aggregation
    PLATE = "plate"  # debug: aggregate along z (plate_test_agg.hpp:14)


class ProlType(str, enum.Enum):
    """Prolongation type (vertex_factory.hpp:69 `prol_type`)."""

    PIECEWISE = "piecewise"
    SMOOTHED = "smoothed"  # Jacobi-smoothed with bounded fan-out (default)


class EnergyType(str, enum.Enum):
    """Where the algebraic-mesh energy comes from (amg_pc.hpp:78 `energy`)."""

    TRIV = "triv"  # unit weights
    ALG = "alg"  # extracted from the assembled matrix (default)
    ELMAT = "elmat"  # accumulated from element matrices


@dataclass
class CoarsenOptions:
    """Options controlling coarsening speed/quality.

    Aggressive-coarsening factors follow base_factory.hpp:100-110
    (`aaf`, `first_aaf`, `aaf_scale`); SPW knobs follow spw_agg.hpp:15-60.
    """

    algo: SpecLike = CoarsenType.AUTO
    # number of pairwise-matching rounds per coarsening step => agg size
    # ~2^r; default: aggressive on the finest level (the reference's
    # `first_aaf` idiom, base_factory.hpp:100-110), moderate above
    spw_rounds: SpecLike = field(
        default_factory=lambda: SpecOpt(2, (3,))
    )
    # goal coarsening factor per step (the reference's `aaf`/`first_aaf`,
    # base_factory.hpp:100-110): when set, pairwise rounds repeat until
    # n_coarse <= aaf * n_fine (overrides spw_rounds); None = fixed rounds
    aaf: SpecLike = None
    # strength-of-connection threshold: edges weaker than theta * max-per-row
    # are never matched (cf. MIS `ecw` options mis_agg.hpp:15-60)
    theta: SpecLike = 0.08
    # robust (generalized-EVP) strength of connection for block energies;
    # None = the energy decides (elasticity defaults to True, H1 to False)
    robust: SpecLike = None
    # neighbor-boost accumulation for the robust SOC (`mis_neib_boost` /
    # AddNeibBoost, agglomerator_utils.hpp:600-667): add transported
    # series energies of common-neighbor paths to each edge matrix before
    # the pencil EVP — makes the strict min-eigenvalue reduction
    # non-degenerate for near-singular (thin-body) block energies
    neib_boost: SpecLike = False
    # scalar prefilter for the robust SOC (the reference's phase-(a)
    # neighbor filtering, spw_agg.hpp:100-112 / spw_agg_impl.hpp:691
    # `scalRelThresh`, default 0.25 there too): only edges whose scalar
    # approximate weight reaches this fraction of EITHER endpoint's row
    # maximum get the (expensive) pencil-EVP robust score; the rest are
    # excluded from matching, exactly like the reference's weights[j]=-1.
    # 0 disables (robust-score every edge).
    scal_rel_thresh: SpecLike = 0.25
    # pencil reduction for the robust SOC: None = the energy's default
    # ("max": rank-1 finest tangential projections), "min" = the
    # reference's strict semantics (use with neib_boost)
    soc_reduction: SpecLike = None
    # fraction of in-agglomerate edge energy RETAINED in coarse aux
    # diagonals between SPW rounds (`diagStabBoost`, spw_agg.hpp:42,
    # spw_agg_impl.hpp:516): 0 = rebuild from coarse edges only (our
    # measured-best default), reference default 0.5 keeps half (more
    # conservative later rounds)
    diag_stab_boost: SpecLike = 0.0
    # agglomerate-wide SOC acceptance check before merging agglomerates
    # in later SPW rounds (`checkBigSOC`/`AggregateWideStabilityCheck`,
    # spw_agg.hpp:31, agglomerator_utils.hpp:394-539): require the
    # diagonal smoother to be rho-dominated by the union's sub-assembled
    # energy orthogonal to the rigid-body space. Reference default: OFF.
    big_soc: SpecLike = False
    # acceptance level rho for the big-SOC check (None = the matching
    # theta, the analog of the reference's min(robThresh, absBigThresh))
    big_soc_rho: SpecLike = None
    # orphan adoption: unmatched vertices join their strongest matched
    # neighbor's aggregate (SPW final round, spw_agg_impl.hpp:1790+)
    adopt_orphans: SpecLike = True
    # drop vertices whose diagonal dominates all couplings (L2-dominant drop,
    # spw_agg round 0)
    l2_drop_tol: float = 0.0

    def __post_init__(self):
        self.algo = as_spec(self.algo)
        self.spw_rounds = as_spec(self.spw_rounds)
        self.aaf = as_spec(self.aaf)
        self.theta = as_spec(self.theta)
        self.robust = as_spec(self.robust)
        self.scal_rel_thresh = as_spec(self.scal_rel_thresh)
        self.neib_boost = as_spec(self.neib_boost)
        self.soc_reduction = as_spec(self.soc_reduction)
        self.diag_stab_boost = as_spec(self.diag_stab_boost)
        self.big_soc = as_spec(self.big_soc)
        self.big_soc_rho = as_spec(self.big_soc_rho)
        self.adopt_orphans = as_spec(self.adopt_orphans)


@dataclass
class ProlOptions:
    """Prolongation options (vertex_factory.hpp:60-99 sp_* knobs)."""

    type: SpecLike = ProlType.SMOOTHED
    # damping in units of 1/rho(Dhat^-1 Ahat); 4/3 = classical SA optimum
    omega: SpecLike = 4.0 / 3.0  # sp_omega
    max_per_row: SpecLike = 4  # sp_max_per_row: fan-out bound (ELL width)
    min_frac: SpecLike = 0.04  # sp_min_frac: drop-tolerance for entries
    # semi-aux choice: rows whose REAL-matrix coarse fan-out is <= this
    # are smoothed with the real level matrix (sp_max_per_row_classic,
    # vertex_factory_impl.hpp:71, default 5); 0 disables (pure aux)
    max_classic: SpecLike = 5

    def __post_init__(self):
        for f in ("type", "omega", "max_per_row", "min_frac", "max_classic"):
            setattr(self, f, as_spec(getattr(self, f)))


@dataclass
class SmootherOptions:
    type: SpecLike = SmootherType.GS
    steps: SpecLike = 1  # number of pre/post sweeps (amg_pc.hpp:67 sm_steps)
    symmetric: SpecLike = True  # forward pre-sweep + backward post-sweep
    omega: SpecLike = 1.0  # damping for jacobi-type smoothers
    # Chebyshev polynomial order; None = auto per energy: 3 for scalar
    # levels, 5 for block (elasticity) levels — the measured defaults that
    # land Poisson at peak throughput and 3D elasticity INSIDE the
    # reference's <40-iteration budget (36 iters at 1.25M DoF; budget:
    # reference tests/elasticity/mdim/simple/test_3d_lo.py:5-11)
    cheby_order: SpecLike = None
    # fraction of lambda_max where the chebyshev window starts;
    # None = auto per energy: 0.30 on scalar levels, 0.25 on block
    # (elasticity) levels — measured at 1.25M-DoF 3D elasticity
    # (cheby_lower x iters x true relres at 0.5e-8 target:
    # 0.30 -> 39 x 9.7e-9, 0.25 -> 38 x 6.6e-9, 0.20 -> 35 x 1.1e-8
    # FAILS strict 1e-8): 0.25 is the best window that keeps the
    # mixed-precision residual drift inside the tolerance
    cheby_lower: SpecLike = None

    def __post_init__(self):
        for f in (
            "type",
            "steps",
            "symmetric",
            "omega",
            "cheby_order",
            "cheby_lower",
        ):
            setattr(self, f, as_spec(getattr(self, f)))


@dataclass
class ClusterCorrOptions:
    """Local cluster correction (smoothers/cluster_corr.py): exact batched
    solves on near-singular strong clusters (sliver tets on low-quality
    meshes), wrapped symmetrically around the cycle. The device analog
    of the reference's dynamic block smoothers
    (dyn_block_smoother.hpp:16) for locally defective rows."""

    enabled: bool = True  # no-op when no defective cluster is detected
    beta: float = 0.35  # |a_ij| >= beta*sqrt(a_ii a_jj) joins a cluster
    eig_ratio: float = 0.3  # defective: lambda_min < ratio * max(diag)
    max_size: int = 16  # larger components are left to the hierarchy


@dataclass
class LevelControl:
    """Level-loop stopping control (base_factory.hpp:96-123)."""

    max_levels: int = 20  # max_n_levels
    max_coarse_size: int = 500  # max_meas: stop once <= this many vertices
    # reject a coarse step whose coarsening ratio exceeds this
    # (base_factory.cpp TryCoarseStep rd_crs_thresh analog)
    min_coarsen_ratio: float = 0.95
    # -- redistribution (contraction) decisions INSIDE the level loop,
    # the TryContractStep/FindRDFac analog (base_factory.cpp:573-682):
    # after each coarse step the distributed setup shrinks the ACTIVE
    # shard group (remaining shards own empty row ranges, like the
    # reference's idle dropped ranks) when a shard's coarse rows fall
    # below rd_min_rows, halving once more when the step's coarsening
    # ratio nc/n exceeds rd_slow_ratio (slow coarsening concentrates
    # sooner). Decisions are logged (FactoryLog.contract_decisions) and
    # cap the device placement (shard_operator shards_hint).
    rd_min_rows: int = 4096
    rd_slow_ratio: float = 0.7


@dataclass
class AMGOptions:
    """Top-level options for :class:`ngsamg.precond.AMGPreconditioner`."""

    cycle: CycleType = CycleType.V
    coarse_solve: CoarseSolveType = CoarseSolveType.INV
    coarsen: CoarsenOptions = field(default_factory=CoarsenOptions)
    prol: ProlOptions = field(default_factory=ProlOptions)
    smoother: SmootherOptions = field(default_factory=SmootherOptions)
    cluster_corr: ClusterCorrOptions = field(
        default_factory=ClusterCorrOptions
    )
    levels: LevelControl = field(default_factory=LevelControl)
    energy: EnergyType = EnergyType.ALG
    # structured fast path: on full-lattice scalar levels run the whole
    # setup in the stencil domain (transfer/stencil.py) — exact Galerkin +
    # SPD-safe stencil pruning, no sparse matrices on the host
    lattice_fast: bool = True
    # coarse-stencil pruning budget (relative to the smallest diagonal);
    # 0 disables (exact Galerkin, but stencils grow 7->33->179->603...)
    stencil_prune_tol: float = 0.02
    # device compute dtype for the solve phase; setup runs f64 on host
    dtype: str = "float32"
    # number of row shards the hierarchy should be divisible into
    # (multi-chip: pads every level to a multiple of 8*shards rows)
    shards: int = 1
    # build the hierarchy with the DISTRIBUTED setup (parallel/dist_setup:
    # shard-local matching/prolongation/RAP with halo exchanges) over this
    # many row shards; 0/1 = serial setup. Scalar H1 energies only.
    dist_setup: int = 0
    # log level (amg_pc.hpp:94-104 LOG_LEVEL_PC)
    log_level: int = 0
    # run the spectral self-test after setup (ngs_amg_do_test analog)
    do_test: bool = False

    def replace(self, **kw) -> "AMGOptions":
        return dataclasses.replace(self, **kw)


def options_from_flags(flags: dict) -> AMGOptions:
    """Build AMGOptions from a flat string-keyed dict.

    Mirrors the reference flag prefix convention (`ngs_amg_*`,
    amg_pc.cpp Options::SetFromFlags) including the ``*_spec`` per-level
    suffix: ``{"sm_type": "gs", "sm_type_spec": ["jacobi"]}`` gives Jacobi on
    level 0 and GS elsewhere (cf. examples/elasticity/beam.py:51-57).
    """
    opts = AMGOptions()
    prefix = "ngs_amg_"
    flat = {}
    for k, v in flags.items():
        k = k.removeprefix(prefix)
        flat[k] = v

    def spec(key, cast):
        """Resolve key [+ key_spec] into a SpecOpt."""
        if key not in flat and key + "_spec" not in flat:
            return None
        default = flat.get(key)
        speclist = flat.get(key + "_spec", ())
        return SpecOpt(
            cast(default) if default is not None else None,
            tuple(cast(s) for s in speclist),
        )

    mapping = [
        ("sm_type", SmootherType, opts.smoother, "type"),
        ("sm_steps", int, opts.smoother, "steps"),
        ("sm_symm", bool, opts.smoother, "symmetric"),
        ("crs_alg", CoarsenType, opts.coarsen, "algo"),
        ("spw_rounds", int, opts.coarsen, "spw_rounds"),
        ("theta", float, opts.coarsen, "theta"),
        ("prol_type", ProlType, opts.prol, "type"),
        ("sp_omega", float, opts.prol, "omega"),
        ("sp_max_per_row", int, opts.prol, "max_per_row"),
        ("sp_min_frac", float, opts.prol, "min_frac"),
    ]
    for key, cast, obj, attr in mapping:
        so = spec(key, cast)
        if so is not None:
            if so.default is None:
                # dataclass defaults are already SpecOpt-wrapped by
                # __post_init__ — unwrap to avoid nesting
                d = getattr(type(obj)(), attr)
                so = SpecOpt(d.default if isinstance(d, SpecOpt) else d, so.spec)
            setattr(obj, attr, so)

    if "aaf" in flat or "first_aaf" in flat:
        # aggressive coarsening factors (base_factory.hpp aaf/first_aaf)
        default = float(flat["aaf"]) if "aaf" in flat else None
        spec = (float(flat["first_aaf"]),) if "first_aaf" in flat else ()
        opts.coarsen.aaf = SpecOpt(default, spec)
    if "mg_cycle" in flat:
        opts.cycle = CycleType(flat["mg_cycle"].upper())
    if "clev" in flat:
        opts.coarse_solve = CoarseSolveType(flat["clev"])
    if "max_levels" in flat:
        opts.levels.max_levels = int(flat["max_levels"])
    if "max_coarse_size" in flat:
        opts.levels.max_coarse_size = int(flat["max_coarse_size"])
    if "energy" in flat:
        opts.energy = EnergyType(flat["energy"])
    if "log_level" in flat:
        opts.log_level = int(flat["log_level"])
    if "do_test" in flat:
        opts.do_test = bool(flat["do_test"])
    if "dtype" in flat:
        opts.dtype = str(flat["dtype"])
    return opts
