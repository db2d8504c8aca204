"""Embeddable steady flow case drivers.

Equivalent of the reference case API (FVENS src/utilities/casesolvers.cpp):
free-stream initialization, the first-order low-tolerance STARTER solve
(:225-314, tolerance failures swallowed) followed by the second-order MAIN
solve (:316-386), and the output functionals (entropy + CL/CDp/CDsf).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..config import FlowCaseConfig, NumericsConfig
from ..fv.residual import FlowFV
from ..mesh.device_mesh import CompiledMesh, compile_mesh
from ..mesh.reader import read_mesh
from ..output import FlowSolutionFunctionals, entropy_error, surface_data
from ..physics.gas import GasPhysics
from ..solver.steady import (SolveInfo, SteadyBackwardEuler,
                             SteadyForwardEuler, ToleranceError)


def build_space(cfg: FlowCaseConfig, order2: bool | None = None) -> FlowFV:
    p = cfg.physics
    phy = GasPhysics(g=p.gamma, Minf=p.Minf, Tinf=p.Tinf, Reinf=p.Reinf,
                     Pr=p.Pr)
    ncfg = cfg.numerics
    if order2 is not None and order2 != ncfg.order2:
        ncfg = dataclasses.replace(ncfg, order2=order2)
    if not ncfg.order2:
        # the starter forces first order: no gradients, no reconstruction
        # (controlparser.cpp:234-246 firstorder_spatial_numerics_config)
        ncfg = dataclasses.replace(ncfg, gradient="NONE",
                                   reconstruction="NONE")
    return FlowFV(phy=phy, pcfg=p, ncfg=ncfg)


def initial_state(space: FlowFV, mesh: CompiledMesh):
    """Uniform free-stream initialization (casesolvers.cpp:52-69)."""
    return jnp.tile(space.uinf.astype(mesh.dtype), (mesh.NC, 1))


def load_case_mesh(cfg: FlowCaseConfig, mesh_file: str | None = None,
                   dtype=jnp.float64) -> CompiledMesh:
    md = read_mesh(mesh_file or cfg.mesh_file)
    return compile_mesh(md, cfg.bcs, dtype=dtype)


@dataclasses.dataclass
class SteadyFlowCase:
    """Starter (first-order, loose tol) -> main (second-order) solve."""
    cfg: FlowCaseConfig

    def _make_solver(self, space, pt, checkpoint: bool = False):
        if pt.stepping == "explicit":
            return SteadyForwardEuler(space, pt)
        fn = None
        if checkpoint and self.cfg.functionals_every and self.cfg.wall_markers:
            from ..output import make_functionals
            fn = make_functionals(space, self.cfg.wall_markers)
        return SteadyBackwardEuler(
            space, pt, self.cfg.linear, self.cfg.nl_update,
            checkpoint_path=(self.cfg.checkpoint_path or None) if checkpoint
            else None,
            checkpoint_every=self.cfg.checkpoint_every,
            functional_fn=fn,
            functional_every=self.cfg.functionals_every)

    def execute_starter(self, mesh, u, log_every: int = 0):
        """First-order startup; tolerance failures are swallowed
        (casesolvers.cpp:294-299). The solver is cached on the case so a
        re-solve reuses its jitted programs (steady.py:_jit)."""
        solver = getattr(self, "_starter_solver", None)
        if solver is None:
            space1 = build_space(self.cfg, order2=False)
            solver = self._starter_solver = self._make_solver(
                space1, self.cfg.init)
        try:
            u, info = solver.solve(mesh, u, log_every=log_every)
        except ToleranceError:
            pass
        return u

    def execute_main(self, mesh, u, log_every: int = 0, logger=None):
        solver = getattr(self, "_main_solver", None)
        if solver is None:
            solver = self._main_solver = self._make_solver(
                build_space(self.cfg), self.cfg.main, checkpoint=True)
        return solver.solve(mesh, u, log_every=log_every, logger=logger)

    def solve(self, mesh, u=None, log_every: int = 0, logger=None):
        space = build_space(self.cfg)
        if u is None:
            u = initial_state(space, mesh)
        if self.cfg.use_starter and self.cfg.numerics.order2:
            u = self.execute_starter(mesh, u, log_every=log_every)
        return self.execute_main(mesh, u, log_every=log_every, logger=logger)

    def run_output(self, mesh, u=None, log_every: int = 0, logger=None
                   ) -> tuple[jnp.ndarray, SolveInfo, FlowSolutionFunctionals]:
        """Solve and compute output functionals (casesolvers.cpp:75-164)."""
        u, info = self.solve(mesh, u, log_every=log_every, logger=logger)
        space = build_space(self.cfg)
        ent = entropy_error(space, mesh, u)
        CL = CDp = CDsf = 0.0
        if self.cfg.wall_markers:
            _, (CL, CDp, CDsf) = surface_data(space, mesh, u,
                                              self.cfg.wall_markers)
        fnls = FlowSolutionFunctionals(mesh_size=mesh.h_param, entropy=ent,
                                       CL=CL, CDp=CDp, CDsf=CDsf)
        return u, info, fnls


@dataclasses.dataclass
class UnsteadyFlowCase:
    """Physical-time integration case (reference UnsteadyFlowCase,
    casesolvers.cpp:420-447: TVDRK is the only integrator implemented).
    Free-stream init, TVD-RK stages to cfg.final_time."""
    cfg: FlowCaseConfig

    def solve(self, mesh, u=None):
        from ..solver.unsteady import TVDRKSolver
        if self.cfg.time_integrator != "TVDRK":
            raise ValueError(
                f"unknown time integrator '{self.cfg.time_integrator}'; "
                "only TVDRK is implemented (as in the reference)")
        space = build_space(self.cfg)
        if u is None:
            u = initial_state(space, mesh)
        solver = TVDRKSolver(space, order=self.cfg.time_order,
                             cfl=self.cfg.phy_cfl)
        u, t, nsteps = solver.solve(mesh, u, self.cfg.final_time)
        return u, t, nsteps

    def run_output(self, mesh, u=None):
        u, t, nsteps = self.solve(mesh, u)
        space = build_space(self.cfg)
        info = SolveInfo(converged=True, steps=nsteps)
        ent = entropy_error(space, mesh, u)
        CL = CDp = CDsf = 0.0
        if self.cfg.wall_markers:
            _, (CL, CDp, CDsf) = surface_data(space, mesh, u,
                                              self.cfg.wall_markers)
        fnls = FlowSolutionFunctionals(mesh_size=mesh.h_param, entropy=ent,
                                       CL=CL, CDp=CDp, CDsf=CDsf)
        return u, info, fnls


@dataclasses.dataclass
class DistributedFlowCase:
    """Multi-device steady flow case: partition -> shard -> starter + main
    solve over the device mesh -> gather.

    Role of the reference's `mpirun -n D fvens_steady` parallel runs
    (tests/inv-2dcyl/CMakeLists.txt:31-37, tests/heat/CMakeLists.txt:144-153):
    the mesh is domain-decomposed onto the jax device mesh, each pseudo-time
    step runs SPMD with neighbour (ppermute) halo exchange inside the
    residual/matvec and psum reductions inside GMRES and the norms.
    """
    cfg: FlowCaseConfig
    n_devices: int = 0                 # 0 = all visible devices

    def solve(self, md, log_every: int = 0, logger=None):
        """md: MeshData (the partitioner needs the raw mesh, not a compiled
        single-device one). Returns (u_global (n_cells, 4), SolveInfo)."""
        import jax

        from ..dist import ShardedFlow, partition_mesh
        devices = list(jax.devices())
        if self.n_devices > len(devices):
            raise ValueError(
                f"DistributedFlowCase: {self.n_devices} devices requested, "
                f"{len(devices)} visible ({devices[0].platform})")
        if self.n_devices:
            devices = devices[: self.n_devices]
        bundle = partition_mesh(md, self.cfg.bcs, len(devices))
        sf_main = ShardedFlow(space=build_space(self.cfg), bundle=bundle,
                              devices=devices)
        u = sf_main.initial_state()
        if self.cfg.use_starter and self.cfg.numerics.order2:
            sf1 = ShardedFlow(space=build_space(self.cfg, order2=False),
                              bundle=bundle, devices=devices)
            try:
                u, _ = sf1.solve_implicit(self.cfg.init, lin=self.cfg.linear,
                                          nl=self.cfg.nl_update, u=u,
                                          log_every=log_every)
            except ToleranceError:
                pass  # starter tolerance failures are swallowed, as in
                #       SteadyFlowCase (casesolvers.cpp:294-299)
        u, info = sf_main.solve_implicit(self.cfg.main, lin=self.cfg.linear,
                                         nl=self.cfg.nl_update, u=u,
                                         log_every=log_every, logger=logger)
        return sf_main.gather_solution(u), info

    def run_output(self, md, log_every: int = 0, logger=None):
        """Solve distributed, then evaluate the output functionals on the
        gathered global state (the reference reduces functionals over ranks;
        gather-then-evaluate is numerically identical for these surface and
        volume integrals)."""
        ug, info = self.solve(md, log_every=log_every, logger=logger)
        mesh = compile_mesh(md, self.cfg.bcs)
        space = build_space(self.cfg)
        import numpy as np
        upad = np.tile(np.asarray(space.uinf), (mesh.NC, 1))
        upad[: mesh.n_cells] = ug
        u = jnp.asarray(upad)
        ent = entropy_error(space, mesh, u)
        CL = CDp = CDsf = 0.0
        if self.cfg.wall_markers:
            _, (CL, CDp, CDsf) = surface_data(space, mesh, u,
                                              self.cfg.wall_markers)
        fnls = FlowSolutionFunctionals(mesh_size=mesh.h_param, entropy=ent,
                                       CL=CL, CDp=CDp, CDsf=CDsf)
        return u, info, fnls
