"""The two cases that prove the solver on a device, built from generated
meshes so that nothing outside the checkout is needed.

naca_laminar: the flagship viscous case (laminar NACA0012, M 0.5,
Re 5000, Roe + least-squares gradients, adiabatic wall, inflow-outflow far
field), as the files a user hands the CLI: the generated 12,800-cell
O-mesh `naca0012_omesh(160, 80)` written as Gmsh 2, an INFO control file
with the reference's starter and main phases, and a PETSc-style .solverc
(`-pc_type bjacobi -sub_pc_type ilu` -> bsgs x6, plus the reference's
`-matrix_free_jacobian`). The Newton operator has to be the matrix-free
one: with the assembled first-order Jacobian alone, the defect correction
diverges at high CFL off this mesh's sharp trailing edge.

cylinder: the inviscid cylinder at M 0.38 (HLLC, least squares, linear
reconstruction) on a root-stretched O-mesh, as a library FlowCaseConfig
with the mixed-precision banded bsgs x6 / FGMRES(90) linear stack. At
640 x 320 (204.8k cells) the GMRES vectors are above the blocked-MGS
threshold of solver/linear.py.
"""

from __future__ import annotations

import os

NACA_CASE = {"nt": 160, "nr": 80, "tol": 1e-9, "maxiter": 400}

_NACA_CTRL = """\
; laminar NACA0012, M 0.5, Re 5000, alpha 0: the flagship viscous case
io {{
  mesh_file "{mesh}"
}}
flow_conditions {{
  flow_type navierstokes
  adiabatic_index 1.4
  angle_of_attack 0.0
  freestream_Mach_number 0.5
  freestream_Reynolds_number 5000.0
  freestream_temperature 288.15
  Prandtl_number 0.72
  use_constant_viscosity false
}}
bc {{
  bc0 {{
    type adiabaticwall
    marker 2
    boundary_values 0.0
  }}
  bc1 {{
    type inflowoutflow
    marker 4
  }}
  listof_output_wall_boundaries 2
}}
time {{
  simulation_type steady
}}
spatial_discretization {{
  inviscid_flux roe
  gradient_method leastsquares
  limiter none
}}
Jacobian_inviscid_flux consistent
pseudotime {{
  pseudotime_stepping_type implicit
  main {{
    cfl_min 500
    cfl_max 5000
    tolerance {tol}
    max_timesteps {maxiter}
  }}
  initialization {{
    cfl_min 200
    cfl_max 1000
    tolerance 1e-1
    max_timesteps 50
  }}
}}
"""

_SOLVERC = """\
-pc_type bjacobi
-sub_pc_type ilu
-matrix_free_jacobian
"""


def write_naca_laminar(outdir: str, nt: int = NACA_CASE["nt"],
                       nr: int = NACA_CASE["nr"],
                       tol: float = NACA_CASE["tol"],
                       maxiter: int = NACA_CASE["maxiter"]) -> tuple:
    """Write naca.msh, naca.ctrl and naca.solverc under `outdir`;
    returns (ctrl_path, solverc_path)."""
    from ..mesh.meshgen import naca0012_omesh
    from .convertformat import write_gmsh2

    os.makedirs(outdir, exist_ok=True)
    mesh = os.path.join(outdir, "naca.msh")
    write_gmsh2(mesh, naca0012_omesh(nt, nr))
    ctrl = os.path.join(outdir, "naca.ctrl")
    with open(ctrl, "w") as f:
        f.write(_NACA_CTRL.format(mesh=os.path.abspath(mesh), tol=tol,
                                  maxiter=maxiter))
    solverc = os.path.join(outdir, "naca.solverc")
    with open(solverc, "w") as f:
        f.write(_SOLVERC)
    return ctrl, solverc


def cylinder_mesh(ni: int = 640, nj: int = 320):
    """Cylinder O-mesh (ni around, nj radial) keeping the cylinder_family's
    radial clustering (stretch 1.15 at nr=20, root-scaled with refinement):
    a fixed 1.15 at nr=320 collapses the first layers to zero area."""
    from ..mesh.meshgen import cylinder_omesh
    return cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj))


def cylinder_config():
    """FlowCaseConfig of the inviscid cylinder: first-order starter, then
    the second-order main solve to rel 1e-6 or abs 1e-10 within 200
    steps."""
    from ..config import (BCSpec, FlowCaseConfig, LinearSolverConfig,
                          NonlinearUpdateConfig, NumericsConfig,
                          PhysicsConfig, PseudoTimeConfig)
    return FlowCaseConfig(
        physics=PhysicsConfig(Minf=0.38, Tinf=288.15, viscous=False),
        numerics=NumericsConfig(flux="HLLC", gradient="LEASTSQUARES",
                                reconstruction="LINEAR", order2=True),
        bcs=[BCSpec(marker=2, type="slipwall"),
             BCSpec(marker=4, type="farfield")],
        main=PseudoTimeConfig(cfl_init=500.0, cfl_fin=5000.0, tol=1e-6,
                              tol_abs=1e-10, maxiter=200),
        init=PseudoTimeConfig(cfl_init=50.0, cfl_fin=1000.0, tol=1e-1,
                              maxiter=200),
        linear=LinearSolverConfig(restart=90, maxiter=90, rtol=1e-2,
                                  pc="bsgs", pc_sweeps=6,
                                  mixed_precision=True, banded=True),
        nl_update=NonlinearUpdateConfig("full"),
        wall_markers=(2,))
