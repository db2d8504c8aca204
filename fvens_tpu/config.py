"""Typed configuration for fvens_tpu.

Collapses the reference's three config layers (INFO control file, program
options, PETSc options DB — FVENS src/utilities/controlparser.cpp:60-216,
doc/example-control-file.ctrl) into plain dataclasses. The .ctrl surface is
kept as an optional reader in fvens_tpu.io_config.ctrl.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# Boundary-condition codes (reference enum: src/spatial/abctypes.hpp:12-21,
# string map abctypemap.cpp:58-73)
BC_SLIPWALL = 0
BC_FARFIELD = 1
BC_INFLOWOUTFLOW = 2
BC_EXTRAPOLATION = 3
BC_ADIABATIC_WALL = 4
BC_ISOTHERMAL_WALL = 5
BC_SUBSONIC_INFLOW = 6
BC_PERIODIC = 7
BC_DIRICHLET = 8          # scalar problems (diffusion)

BC_NAMES = {
    "slipwall": BC_SLIPWALL,
    "farfield": BC_FARFIELD,
    "inflowoutflow": BC_INFLOWOUTFLOW,
    "extrapolation": BC_EXTRAPOLATION,
    "adiabaticwall": BC_ADIABATIC_WALL,
    "isothermalwall": BC_ISOTHERMAL_WALL,
    "subsonic_inflow": BC_SUBSONIC_INFLOW,
    "periodic": BC_PERIODIC,
    "dirichlet": BC_DIRICHLET,
}

# Inviscid numerical fluxes (factory keys, afactory.cpp:31-98)
FLUXES = ("LLF", "VANLEER", "AUSM", "AUSMPLUS", "ROE", "HLL", "HLLC")
GRADIENT_SCHEMES = ("NONE", "GREENGAUSS", "LEASTSQUARES")
RECONSTRUCTIONS = ("NONE", "LINEAR", "WENO", "VANALBADA", "BARTHJESPERSEN",
                   "VENKATAKRISHNAN")


@dataclasses.dataclass(frozen=True)
class BCSpec:
    """One boundary condition: mesh marker + type + optional values.

    values meaning by type (ref abc.cpp / example-control-file.ctrl):
      adiabaticwall:   (wall tangential velocity,)
      isothermalwall:  (wall tangential velocity, wall temperature [K])
      subsonic_inflow: (total pressure [nondim], total temperature [K])
      periodic:        axis handled via `periodic_axis`
      dirichlet:       (boundary value,)
    """
    marker: int
    type: str
    values: tuple = ()
    periodic_axis: int = 0


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Free-stream/thermodynamic setup (ref FlowParserOptions + IdealGasPhysics)."""
    gamma: float = 1.4
    Minf: float = 0.5
    Tinf: float = 288.15
    Reinf: float = 5000.0
    Pr: float = 0.72
    aoa_deg: float = 0.0          # angle of attack in degrees
    viscous: bool = False         # navierstokes vs euler
    const_visc: bool = False      # constant mu instead of Sutherland

    @property
    def aoa(self) -> float:
        import math
        return math.radians(self.aoa_deg)


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    """Spatial discretization selection (ref FlowNumericsConfig)."""
    flux: str = "HLLC"                 # inviscid numerical flux
    flux_jacobian: str = "CONSISTENT"  # implicit Jacobian flux: CONSISTENT
    #                                    = exact AD of the same flux, FROZEN
    #                                    = frozen wave speeds (the
    #                                    reference's linearization), or a name
    gradient: str = "LEASTSQUARES"     # NONE / GREENGAUSS / LEASTSQUARES
    reconstruction: str = "LINEAR"     # see RECONSTRUCTIONS
    limiter_param: float = 20.0        # WENO lambda / Venkatakrishnan K
    order2: bool = True


@dataclasses.dataclass(frozen=True)
class PseudoTimeConfig:
    """One pseudo-time continuation solve (ref SteadySolverConfig,
    aodesolver.hpp:18-30)."""
    cfl_init: float = 500.0
    cfl_fin: float = 5000.0
    tol: float = 1e-6
    tol_abs: float = 0.0               # >0: also stop at this ABSOLUTE
    #                                    residual (area-weighted energy norm);
    #                                    useful where the state's precision
    #                                    sets an absolute residual floor
    maxiter: int = 500
    stepping: str = "implicit"         # implicit | explicit
    use_local_dt: bool = True
    cfl_ramp: str = "exp"              # exp: residual-based ramp (reference
    #                                    default, aodesolver.cpp:110-120);
    #                                    linear: step-indexed linear ramp
    #                                    (SteadySolver::linearRamp,
    #                                    aodesolver.cpp:88-108)
    rampstart: int = 0                 # linear ramp: step CFL leaves cfl_init
    rampend: int = 0                   # linear ramp: step CFL reaches cfl_fin
    device_steps: int = 1              # pseudo-time steps per device
    #                                    program launch: >1 runs the CFL
    #                                    ramp + Krylov forcing controller
    #                                    inside the jitted program (lax.scan)
    #                                    and syncs to the host only at chunk
    #                                    boundaries — removes the per-step
    #                                    host round trip. Anomalies (NaN,
    #                                    blowup, stall) exit the chunk and
    #                                    fall back to the single-step host
    #                                    recovery path.
    bake_mesh: bool = False            # close the mesh over the jitted step
    #                                    as a COMPILED CONSTANT instead of a
    #                                    runtime argument. Constant-folding
    #                                    makes the program O(mesh) large
    #                                    (caps usable meshes ~205k cells via
    #                                    the remote-compile upload limit) but
    #                                    removes the per-call host marshal of
    #                                    the mesh pytree (t_dispatch). Use
    #                                    for solves on meshes that fit;
    #                                    classic path (no warm start/
    #                                    deflation) only.
    pipeline: bool = False             # software-pipelined host stepping:
    #                                    dispatch step k+1 BEFORE fetching
    #                                    step k's residual, with the CFL/
    #                                    forcing controller evaluated as a
    #                                    tiny separate device program
    #                                    (controller_advance), so the
    #                                    per-step host round trip overlaps
    #                                    the next step's device compute.
    #                                    Unlike device_steps, the step
    #                                    program itself is byte-identical to
    #                                    the single-step path (no scan/cond
    #                                    fusion loss). Anomaly checks run on
    #                                    the fetched scalars one step behind;
    #                                    speculative steps are discarded on
    #                                    anomaly/convergence. Classic path
    #                                    (exp ramp, no warm start/deflation/
    #                                    bake_mesh) only.
    blowup_relres: float = 1e5         # residual growth beyond this factor
    #                                    over the initial residual counts as
    #                                    numerical blowup: the implicit solver
    #                                    restarts from its best-seen state at
    #                                    reduced CFL (shock-phase trust
    #                                    region, beyond the reference which
    #                                    throws only on NaN)


@dataclasses.dataclass(frozen=True)
class LinearSolverConfig:
    """Krylov settings. Reference defaults are FGMRES(30) rtol 1e-1 with
    bjacobi+ILU0 (testcases/defaults.solverc); the data-parallel stand-in
    for ILU0 strength is the multicolor block-SGS (bcsgs), which needs a few
    more Krylov iterations on stiff viscous meshes."""
    restart: int = 90
    maxiter: int = 90
    rtol: float = 1e-2                 # Krylov tolerance (floor when adaptive)
    rtol_adapt: bool = True            # Eisenstat-Walker forcing: loose while
    #                                    the outer iteration stalls (damping),
    #                                    tight while it converges
    rtol_max: float = 0.2
    pc: str = "bcsgs"                  # none | bjacobi | bsgs | bcsgs |
    #                                    bline | amg
    pc_sweeps: int = 3                 # sweeps for iterative PCs
    # pc='amg' (aggregation multigrid, solver/multigrid.py) options:
    mg_levels: int = 3                 # coarsening steps in the hierarchy
    mg_nu1: int = 2                    # pre-smoothing sweeps per level
    mg_nu2: int = 2                    # post-smoothing sweeps per level
    mg_coarse_sweeps: int = 10         # smoother sweeps on the coarsest level
    mg_cycles: int = 1                 # V-cycles per preconditioner apply
    ilu_setup_sweeps: int = 4          # pc='ilu0': Chow-Patel fixed-point
    #                                    factorization sweeps per Newton step
    #                                    (solver/ilu.py; the parallel form of
    #                                    the reference's BLASTed async ILU0,
    #                                    defaults.solverc:16-19). pc_sweeps
    #                                    then counts the truncated-Neumann
    #                                    sweeps per triangular solve
    deflation_k: int = 0               # >0: GCRO-DR subspace recycling —
    #                                    carry k approximate slow directions
    #                                    of the Jacobian across Newton steps
    #                                    and deflate them from every Krylov
    #                                    solve (solver/linear.py:gmres_dr).
    #                                    A data-parallel route to the
    #                                    reference's ILU0-class iteration
    #                                    counts (all added work is
    #                                    tall-skinny dense algebra)
    deflation_start_relres: float = 1e-2   # enable recycling only below this
    #                                    rel-residual: during the transient
    #                                    phase the Jacobian changes violently
    #                                    between steps, recycled spaces are
    #                                    stale, and deflating with them
    #                                    derails the Newton path (measured:
    #                                    79 -> 176 steps ungated); the
    #                                    endgame — where the iterations
    #                                    actually pile up — has a nearly
    #                                    constant Jacobian
    banded: bool = False               # banded (shifted-slice) neighbour
    #                                    encoding for the matvec and the
    #                                    bjacobi/bsgs sweeps
    #                                    (solver/banded.py): on structured
    #                                    O-meshes the per-iteration slot
    #                                    gather becomes K contiguous rolls.
    #                                    Opt-in — neighbour summation order
    #                                    changes, so trajectories agree only
    #                                    to rounding; silently falls back to
    #                                    the gather path on meshes that are
    #                                    not band-coverable
    matrix_free: bool = False
    matrix_free_fd: bool = False       # matrix-free matvec via the
    #                                    reference's eps/||x|| finite
    #                                    difference (alinalg.cpp:143-233)
    #                                    instead of the exact jax.jvp
    fd_eps: float = 1e-7               # -matrix_free_difference_step default
    mixed_precision: bool = False      # f32 Jacobian/Krylov/preconditioner
    #                                    around an f64 residual + update:
    #                                    reaches 1e-10 residuals with the
    #                                    Krylov phase at f32 cost
    warm_start: bool = False           # start GMRES from the previous
    #                                    step's Newton direction


@dataclasses.dataclass(frozen=True)
class NonlinearUpdateConfig:
    scheme: str = "full"               # full | robust_flow
    min_factor: float = 0.2


@dataclasses.dataclass(frozen=True)
class FlowCaseConfig:
    """Everything needed to run a steady flow case end to end."""
    physics: PhysicsConfig = PhysicsConfig()
    numerics: NumericsConfig = NumericsConfig()
    bcs: Sequence[BCSpec] = ()
    main: PseudoTimeConfig = PseudoTimeConfig()
    init: PseudoTimeConfig = PseudoTimeConfig(
        cfl_init=200.0, cfl_fin=1000.0, tol=1e-1, maxiter=50)
    use_starter: bool = True
    linear: LinearSolverConfig = LinearSolverConfig()
    nl_update: NonlinearUpdateConfig = NonlinearUpdateConfig()
    wall_markers: tuple = ()           # markers to integrate CL/CD over
    mesh_file: str = ""
    checkpoint_path: str = ""          # main-solve checkpoint/resume file
    checkpoint_every: int = 50
    functionals_every: int = 0         # log device-evaluated functionals
    #                                    (entropy/CL/CDp/CDsf) every N steps
    # unsteady (time { simulation_type unsteady }, controlparser.cpp:165-177)
    sim_type: str = "steady"           # steady | unsteady
    final_time: float = 0.0
    time_integrator: str = "TVDRK"     # the reference implements TVDRK only
    time_order: int = 3                # TVDRK stage order (1/2/3)
    phy_cfl: float = 0.5               # physical CFL for TVDRK
