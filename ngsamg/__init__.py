"""ngsamg — algebraic multigrid in JAX, with the solve phase on the accelerator.

A from-scratch re-creation of the capabilities of NgsAMG (auxiliary-topology
agglomeration AMG for H1 / elasticity / Stokes problems): host-side
vectorized setup producing a static level pytree, a JAX/XLA device solve
phase, and `jax.sharding`-based multi-device scaling.

Public API:
    AMGPreconditioner / amg_preconditioner — strict-algebraic-mode front-end
    AMGOptions, options_from_flags, SpecOpt — configuration
    apps.h1.H1Energy, apps.elasticity.ElasticityEnergy — PDE energies
    utils.fem — test/benchmark problem generators
"""

from .config import (
    AMGOptions,
    CoarsenType,
    CoarseSolveType,
    CycleType,
    ProlType,
    SmootherType,
    SpecOpt,
    options_from_flags,
)
from .precond.amg import AMGPreconditioner, amg_preconditioner

__version__ = "0.1.0"

__all__ = [
    "AMGOptions",
    "AMGPreconditioner",
    "amg_preconditioner",
    "CoarsenType",
    "CoarseSolveType",
    "CycleType",
    "ProlType",
    "SmootherType",
    "SpecOpt",
    "options_from_flags",
]
