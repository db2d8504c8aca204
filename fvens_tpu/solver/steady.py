"""Steady-state pseudo-time continuation solvers.

Explicit forward Euler with local time steps and implicit backward Euler
(pseudo-transient continuation / quasi-Newton), mirroring the reference's
SteadyForwardEulerSolver / SteadyBackwardEulerSolver
(FVENS src/ode/aodesolver.cpp:136-638):

  - residual norm = sqrt( sum_cells r_energy^2 * area )  (:516-527)
  - convergence on resi/initres with initres from the first step
  - exponential residual-based CFL ramp
    CFL_{n+1} = clamp(CFL_n * (res_{n-1}/res_n)^p)  (:110-120)
  - implicit step: (Vol/(CFL dt) I + J1) du = rhs, u += omega du with the
    first-order Jacobian J1 (defect-correction quasi-Newton)
  - NaN residual -> Numerical_error; non-convergence -> Tolerance_error.

Each pseudo-time step is one jitted device program; the tiny scalar control
flow (CFL ramp, convergence test) stays on the host.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (LinearSolverConfig, NonlinearUpdateConfig,
                      PseudoTimeConfig)
from . import jacobian as jacmod
from .linear import bsr_matvec, gmres, make_bsr_matvec, make_preconditioner
from .precision import einsum
from .relaxation import get_update_scheme


class NumericalError(ArithmeticError):
    """Residual became NaN/inf (ref aerrorhandling.hpp:16-40)."""


class ToleranceError(RuntimeError):
    """Did not converge to tolerance within max iterations."""


@dataclasses.dataclass
class SolveInfo:
    converged: bool = False
    steps: int = 0
    initres: float = 0.0
    finalres: float = 0.0
    total_lin_iters: int = 0
    walltime: float = 0.0
    history: list = dataclasses.field(default_factory=list)
    # host-loop timing breakdown (single-step implicit path): async enqueue
    # wall vs device-compute + fetch wall
    t_dispatch: float = 0.0
    t_fetch: float = 0.0
    step_times: list = dataclasses.field(default_factory=list)


def residual_norm(mesh, rhs):
    """Energy-component L2 norm weighted by cell area (aodesolver.cpp:516-527)."""
    r = rhs[:, -1] if rhs.ndim == 2 else rhs
    return jnp.sqrt(((r * r) * mesh.area * mesh.cell_mask).sum())


def exp_residual_ramp(cflmin, cflmax, prevcfl, resratio, pup, pdown):
    """(aodesolver.cpp:110-120), host scalars."""
    p = pup if resratio > 1.0 else pdown
    newcfl = prevcfl * resratio ** p
    return float(min(max(newcfl, cflmin), cflmax))


def linear_ramp(cstart, cend, itstart, itend, itcur):
    """Step-indexed linear CFL ramp (SteadySolver::linearRamp,
    aodesolver.cpp:88-108), host scalars."""
    if itcur < itstart:
        return float(cstart)
    if itcur < itend:
        if itend - itstart <= 0:
            return float(cend)
        slope = (cend - cstart) / (itend - itstart)
        return float(cstart + slope * (itcur - itstart))
    return float(cend)


def controller_advance(cfg, lin, xp, cfl, cfl_cap, rtol, rtol_floor,
                       raise_relres, res, resold, initres, ramped_cfl=None):
    """One CFL-ramp + trust-region-cap + Krylov-forcing controller update.

    THE single source of truth for the per-step controller arithmetic,
    evaluated by BOTH the host loop (xp=numpy on concrete f64 scalars) and
    the chunked on-device controller (xp=jnp under trace): the two paths
    cannot drift. All ops (pow, min/max, clip, where-selects) produce
    bit-identical IEEE doubles in either module.

    ramped_cfl: pre-computed CFL (the step-indexed linear ramp) replacing
    the exponential residual-based ramp; the trust-region cap still applies.

    Forcing controller: residual growth or stall -> LOOSEN the Krylov
    tolerance (inexact solves damp nonlinear limit cycles); steady progress
    -> TIGHTEN toward the configured floor. Growth AT the floor raises the
    floor (a ratchet); the floor decays back once the residual falls 100x
    below the level where the limit cycle lived, else the loose directions
    stall the deep-convergence endgame near the precision floor.
    """
    ratio = resold / res
    if ramped_cfl is None:
        p = xp.where(ratio > 1.0, 0.25, 0.3)
        cfl = xp.clip(cfl * ratio ** p, cfg.cfl_init, cfg.cfl_fin)
    else:
        cfl = ramped_cfl
    cfl_cap = xp.minimum(cfl_cap * 1.05, cfg.cfl_fin)
    cfl = xp.minimum(cfl, cfl_cap)
    if lin.rtol_adapt:
        r2 = res / resold
        grow = r2 > 1.2
        prog = r2 <= 1.0
        at_floor = rtol <= rtol_floor * 1.01
        floor_g = xp.where(at_floor,
                           xp.minimum(rtol_floor * 4.0, lin.rtol_max),
                           rtol_floor)
        raise_g = xp.where(at_floor,
                           xp.maximum(raise_relres, res / initres),
                           raise_relres)
        rtol_g = xp.minimum(xp.maximum(rtol * 2.0, floor_g), lin.rtol_max)
        floor_p = xp.where(res / initres < 1e-2 * raise_relres,
                           xp.maximum(lin.rtol, rtol_floor * 0.7),
                           rtol_floor)
        rtol_p = xp.maximum(rtol * 0.3, floor_p)
        rtol_floor = xp.where(grow, floor_g,
                              xp.where(prog, floor_p, rtol_floor))
        raise_relres = xp.where(grow, raise_g, raise_relres)
        rtol = xp.where(grow, rtol_g, xp.where(prog, rtol_p, rtol))
    return cfl, cfl_cap, rtol, rtol_floor, raise_relres


@dataclasses.dataclass
class SteadyForwardEuler:
    space: object                   # FlowFV or DiffusionFV
    cfg: PseudoTimeConfig

    def _step(self, mesh, u):
        rhs, dt = self.space.compute_residual(mesh, u, True)
        # NOTE: the reference applies cfl_init (not the ramped CFL) in the
        # explicit update (aodesolver.cpp:249) — mirrored for parity.
        unew = u + (self.cfg.cfl_init * dt * mesh.inv_area)[:, None] * rhs
        return unew, residual_norm(mesh, rhs)

    def solve(self, mesh, u0, log_every: int = 0, logger=None) -> tuple:
        # the mesh is a jit ARGUMENT (CompiledMesh is a registered pytree),
        # not a closed-over constant: baking O(mesh) arrays into the XLA
        # program as literals makes the program size grow with the mesh,
        # which capped usable meshes at ~205k cells (round-2 finding)
        # one jitted program per solver instance: rebuilding the jit
        # wrapper per solve() would retrace on every solve (see
        # SteadyBackwardEuler._jit)
        step_fn = getattr(self, "_step_jit", None)
        if step_fn is None:
            step_fn = self._step_jit = jax.jit(self._step)
        u = u0
        info = SolveInfo()
        t0 = time.perf_counter()
        res = initres = 1.0
        step = 0
        if logger is None and log_every:
            from ..io_config.logs import ConvergenceLogger
            logger = ConvergenceLogger(print_every=log_every, label="FE")
        while step < self.cfg.maxiter:
            u, resj = step_fn(mesh, u)
            res = float(resj)
            if not np.isfinite(res):
                raise NumericalError("explicit solve diverged: residual NaN/inf")
            if step == 0:
                initres = res
            step += 1
            if logger:
                logger.log(step, res / initres, res, cfl=self.cfg.cfl_init)
            if (res / initres <= self.cfg.tol
                    or (self.cfg.tol_abs and res <= self.cfg.tol_abs)):
                break
        info.walltime = time.perf_counter() - t0
        info.steps = step
        info.initres = initres
        info.finalres = res
        info.converged = (res / initres <= self.cfg.tol
                          or bool(self.cfg.tol_abs
                                  and res <= self.cfg.tol_abs))
        if not info.converged:
            raise ToleranceError("explicit steady solve did not converge")
        return u, info


@dataclasses.dataclass
class SteadyBackwardEuler:
    space: object
    cfg: PseudoTimeConfig
    lin: LinearSolverConfig = LinearSolverConfig()
    nl: NonlinearUpdateConfig = NonlinearUpdateConfig()
    checkpoint_path: Optional[str] = None     # save/resume state here
    checkpoint_every: int = 50
    # device-side functional logging (output.make_functionals): every
    # `functional_every` steps the jitted evaluator runs ON DEVICE and its
    # scalars join the step's single fused fetch — no host pull of the
    # state/gradients per evaluation (the reference recomputes surface
    # functionals host-side only at the end, aoutput.cpp:150-299)
    functional_fn: Optional[object] = None
    functional_every: int = 0

    log_label = "BE"      # class attr (not a field): logger prefix

    def _lines(self, mesh):
        """Host-side line detection, cached per mesh (pc='bline' only).

        Must be called (at least once per mesh) OUTSIDE any jit trace:
        building the jnp arrays of the LineStructure inside a trace turns
        the constants into tracers, and caching those poisons later traces
        (UnexpectedTracerError on the next solve with the same solver).
        solve() prewarms the cache eagerly before jitting the step."""
        if self.lin.pc != "bline":
            return None
        cache = getattr(self, "_lines_cache", None)
        if isinstance(mesh.area, jax.core.Tracer):
            # called during tracing (the mesh is a jit argument now): the
            # host line-detection pass cannot run on tracers — use the
            # structure prewarmed by solve(). The LineStructure arrays stay
            # closed-over constants (program size O(mesh) for pc='bline'
            # only; the default pcs keep the O(1)-size program).
            if cache is None:
                raise RuntimeError(
                    "pc='bline' line cache not prewarmed before tracing")
            return cache[1]
        key = id(mesh)
        if cache is None or cache[0] != key:
            from .lines import lines_from_mesh
            self._lines_cache = (key, lines_from_mesh(mesh))
        return self._lines_cache[1]

    def _mg(self, mesh):
        """Host-side AMG hierarchy build, cached per mesh (pc='amg' only).
        Passed to _step as a jit ARGUMENT (integer pytree), so the compiled
        program stays O(1) in the mesh size."""
        if self.lin.pc != "amg":
            return None
        cache = getattr(self, "_mg_cache", None)
        key = id(mesh)
        if cache is None or cache[0] != key:
            from .multigrid import build_hierarchy
            self._mg_cache = (key, build_hierarchy(
                mesh, n_levels=self.lin.mg_levels))
        return self._mg_cache[1]

    def _mg_opts(self):
        return dict(nu1=self.lin.mg_nu1, nu2=self.lin.mg_nu2,
                    coarse_sweeps=self.lin.mg_coarse_sweeps,
                    cycles=self.lin.mg_cycles)

    def _banded(self, mesh):
        """Host-side band analysis, cached per mesh (lin.banded only).
        An int pytree passed to _step as a jit ARGUMENT (offsets are static
        metadata). None when the mesh is not band-coverable — the step then
        keeps the gather path (solver/banded.py)."""
        if not self.lin.banded:
            return None
        cache = getattr(self, "_banded_cache", None)
        key = id(mesh)
        if cache is None or cache[0] != key:
            from .banded import banded_structure
            self._banded_cache = (key, banded_structure(mesh))
        return self._banded_cache[1]

    def _ilu(self, mesh):
        """Host-side ILU0 sparsity analysis, cached per mesh (pc='ilu0'
        only). A static-int pytree passed to _step as a jit ARGUMENT, so
        the compiled program stays O(1) in the mesh size."""
        if self.lin.pc != "ilu0":
            return None
        cache = getattr(self, "_ilu_cache", None)
        key = id(mesh)
        if cache is None or cache[0] != key:
            from .ilu import ilu_structure
            self._ilu_cache = (key, ilu_structure(mesh))
        return self._ilu_cache[1]

    def _jit(self, key, make):
        """Per-instance cache of jitted step programs.

        jax.jit(self._step) builds a FRESH wrapper (fresh trace cache) on
        every call: rebuilding it inside solve() made every solve pay the
        full retrace + executable-cache load again. The program depends
        only on self's configs (and, for baked variants, the mesh identity
        baked into `key`), so caching by key on the instance is safe and
        trajectory-neutral."""
        cache = getattr(self, "_jit_programs", None)
        if cache is None:
            cache = self._jit_programs = {}
        if key not in cache:
            cache[key] = make()
        return cache[key]

    def _step(self, mesh, u, cfl, rtol, omega_cap=1.0, du0=None,
              return_du=False, lmesh=None, mg=None, U0=None,
              return_defl=False, ilu=None, bl=None):
        """One implicit pseudo-time step.

        `du0` (optional): previous Newton direction as the Krylov initial
        guess (lin.warm_start). `return_du` (static): also return the new
        direction for the warm-start carry. Both default OFF, in which case
        the traced program is EXACTLY the classic step — the default path's
        XLA fusion (and therefore its floating-point trajectory) must not
        change underneath converged regression cases.

        `lmesh` (optional): precomputed low-precision mesh for the mixed-
        precision path. With the mesh as a jit argument (not a baked
        constant) the f32 cast is no longer free at compile time, so solve()
        casts once on the host and threads the copy through here."""
        rhs, dt = self.space.compute_residual(mesh, u, True)

        # mixed precision: the Newton DIRECTION tolerates f32 (it is just
        # another inexactness), while the residual/update stay f64 so the
        # outer iteration can reach 1e-10.
        mixed = (self.lin.mixed_precision
                 and u.dtype == jnp.float64)
        if mixed:
            lmesh = mesh.astype(jnp.float32) if lmesh is None else lmesh
            lu = u.astype(jnp.float32)
            lrhs = rhs.astype(jnp.float32)
            lcfl = jnp.asarray(cfl, jnp.float32)
            ldt = dt.astype(jnp.float32)
        else:
            lmesh, lu, lrhs, lcfl, ldt = mesh, u, rhs, cfl, dt

        jac = self.space.assemble_jacobian(lmesh, lu)
        jac = jacmod.add_pseudotime_term(lmesh, jac, lcfl, ldt)

        banded_on = (bl is not None and not self.lin.matrix_free
                     and self.lin.pc in ("bjacobi", "bsgs"))
        if banded_on:
            # banded (shifted-slice) operators: the per-iteration slot
            # gathers become K contiguous rolls (solver/banded.py); block
            # reordering is paid once per Newton step
            from .banded import (banded_dn_blocks, make_banded_bsgs,
                                 rest_dn_blocks)
            from .linear import block_jacobi_inverse
            Dinv_b = block_jacobi_inverse(jac.D)
            if self.lin.pc == "bjacobi":
                pc = lambda v: einsum("cij,cj->ci", Dinv_b, v)
            else:
                pc = make_banded_bsgs(
                    Dinv_b, banded_dn_blocks(bl, Dinv_b, jac.N),
                    bl.offsets, self.lin.pc_sweeps,
                    bl=bl, DNr=rest_dn_blocks(bl, Dinv_b, jac.N))
        else:
            pc = make_preconditioner(lmesh, jac, self.lin.pc,
                                     self.lin.pc_sweeps,
                                     lines=self._lines(mesh), mg=mg,
                                     mg_opts=self._mg_opts(), ilu=ilu,
                                     ilu_setup=self.lin.ilu_setup_sweeps)
        if self.lin.matrix_free:
            if self.lin.matrix_free_fd:
                # the reference's finite-difference shell stays in the
                # state's full precision (f32 differencing would lose the
                # perturbation to truncation) — the parity path
                diag = (mesh.area / (cfl * dt) * mesh.cell_mask)[:, None]
                eps0 = self.lin.fd_eps

                def matvec(x):
                    # perturbation eps/||x||, J x ~ (r(u + p x) - r(u))/p
                    # with r = -rhs (alinalg.cpp:126,167-202)
                    p = eps0 / jnp.maximum(
                        jnp.sqrt((x * x).sum()), 1e-300)
                    rp = self.space.compute_residual(mesh, u + p * x,
                                                     False)[0]
                    return diag * x - (rp - rhs) / p
            else:
                # exact JVP of -rhs plus the pseudo-time diagonal (tighter
                # than the reference's FD approximation). Under mixed
                # precision the JVP linearizes the f32 residual at the f32
                # state: the Newton DIRECTION tolerates f32 like the
                # assembled path — this is the exact-Newton outer axis at
                # f32 Krylov cost
                diag = (lmesh.area / (lcfl * ldt)
                        * lmesh.cell_mask)[:, None]

                def matvec(x):
                    _, tang = jax.jvp(
                        lambda v: self.space.compute_residual(
                            lmesh, v, False)[0],
                        (lu,), (x,))
                    return diag * x - tang
        elif banded_on:
            from .banded import (banded_blocks, make_banded_matvec,
                                 rest_blocks)
            matvec = make_banded_matvec(jac.D, banded_blocks(bl, jac.N),
                                        bl.offsets, bl=bl,
                                        R=rest_blocks(bl, jac.N))
        else:
            matvec = make_bsr_matvec(lmesh, jac)   # fused operand built once

        if du0 is not None:
            x0 = du0.astype(lrhs.dtype)
            # a non-finite stale guess must never poison the solve
            x0 = jnp.where(jnp.isfinite(x0).all(), x0, jnp.zeros_like(x0))
        else:
            x0 = jnp.zeros_like(lrhs)
        if return_defl:
            # GCRO-DR subspace recycling (lin.deflation_k): a SEPARATE
            # traced program from the classic step, so the default
            # trajectory stays bit-identical (same rule as warm_start)
            from .linear import gmres_dr
            du, iters, relres, U_new = gmres_dr(
                matvec, lrhs, x0, pc, U=U0, k=self.lin.deflation_k,
                restart=self.lin.restart, maxiter=self.lin.maxiter,
                rtol=rtol)
        else:
            du, iters, relres = gmres(matvec, lrhs, x0, pc,
                                      restart=self.lin.restart,
                                      maxiter=self.lin.maxiter,
                                      rtol=rtol)
        if mixed:
            du = du.astype(u.dtype)

        omega = get_update_scheme(self.nl.scheme)(
            getattr(self.space, "phy", None), u, du, self.nl.min_factor)
        omega = jnp.minimum(omega, omega_cap)

        phy = getattr(self.space, "phy", None)
        if phy is not None and u.shape[-1] == 4:
            # per-cell positivity line search (beyond the reference, which
            # can accept negative-pressure states at high CFL and NaN on the
            # next step): halve the local factor until density and pressure
            # stay above 1% of their current values; 0 if even 1/32 fails
            rho0 = u[:, 0]
            p0 = phy.pressure(u)

            def positive(om):
                ut = u + (omega * om)[:, None] * du
                return (ut[:, 0] > 0.01 * rho0) & (phy.pressure(ut)
                                                   > 0.01 * p0)

            scale = jnp.zeros_like(omega)
            for om in (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125):
                scale = jnp.where((scale == 0.0) & positive(om), om, scale)
            omega = omega * scale
        unew = u + omega[:, None] * du
        # poison the reported norm if ANY residual/state component is
        # non-finite (the energy norm alone can stay finite while momentum
        # components are NaN, silently freezing the solve)
        ok = (jnp.isfinite(rhs).all() & jnp.isfinite(unew).all()
              & jnp.isfinite(relres) & jnp.isfinite(du).all())
        res = jnp.where(ok, residual_norm(mesh, rhs), jnp.nan)
        if return_defl:
            if return_du:
                return unew, res, iters, du, U_new
            return unew, res, iters, U_new
        if return_du:
            return unew, res, iters, du
        return unew, res, iters

    def _chunk(self, K, mesh, u, du, u_best, res_best, stall,
               cfl, cfl_cap, rtol, rtol_floor, raise_relres, res, resold,
               initres, lmesh=None, mg=None, ilu=None, bl=None):
        """Run up to K pseudo-time steps fully on device (lax.scan): the CFL
        exp-residual ramp and the Krylov forcing controller are the same
        arithmetic as the host loop in solve(). Exits early (flag != 0) on
        convergence (1), NaN/blowup (2), or a frozen residual (3), which
        the host recovery logic handles after syncing.

        Syncing once per chunk instead of once per step removes the
        per-step host round trip, which matters on latency-bound
        small-mesh solves; the scan/cond wrapping can cost some XLA fusion
        quality, so this is opt-in via PseudoTimeConfig.device_steps."""
        sd = u.dtype
        cfg, lin = self.cfg, self.lin
        f = lambda x: jnp.asarray(x, sd)

        def live(c):
            (u, du, u_best, res_best, stall, cfl, cfl_cap,
             rtol, rtol_floor, raise_relres, res, resold, flag, iters,
             nsteps) = c
            # the SAME controller arithmetic as the host loop, by
            # construction: one shared function (controller_advance)
            cfl, cfl_cap, rtol, rtol_floor, raise_relres = \
                controller_advance(cfg, lin, jnp, cfl, cfl_cap, rtol,
                                   rtol_floor, raise_relres, res, resold,
                                   initres)
            if self.lin.warm_start:
                u_new, resj, itj, du_new = self._step(mesh, u, cfl, rtol,
                                                      1.0, du,
                                                      return_du=True,
                                                      lmesh=lmesh, mg=mg,
                                                      ilu=ilu, bl=bl)
            else:
                u_new, resj, itj, du_new = self._step(mesh, u, cfl, rtol,
                                                      1.0, return_du=True,
                                                      lmesh=lmesh, mg=mg,
                                                      ilu=ilu, bl=bl)
            finite = jnp.isfinite(resj)
            blown = finite & (resj > cfg.blowup_relres * initres)
            healthy = finite & ~blown
            improved = healthy & (resj < res_best)
            u_best = jnp.where(improved, u, u_best)
            res_best = jnp.where(improved, resj, res_best)
            frozen = healthy & (jnp.abs(resj / res - 1.0) < 1e-12) \
                & (resj / initres > cfg.tol)
            stall = jnp.where(frozen, stall + 1, 0)
            done = healthy & ((resj / initres <= cfg.tol)
                              | ((resj <= cfg.tol_abs) if cfg.tol_abs
                                 else False))
            need_host = stall >= 4
            flag = jnp.where(~healthy, 2,
                             jnp.where(done, 1,
                                       jnp.where(need_host, 3, 0)))
            u = jnp.where(healthy, u_new, u)
            du = jnp.where(healthy, du_new, jnp.zeros_like(du))
            resold = jnp.where(healthy, res, resold)
            i32 = jnp.int32
            return (u, du, u_best, res_best, stall.astype(i32), cfl,
                    cfl_cap, rtol, rtol_floor, raise_relres, resj, resold,
                    flag.astype(i32), (iters + itj).astype(i32),
                    (nsteps + 1).astype(i32))

        def body(c, _):
            flag = c[12]
            c = jax.lax.cond(flag != 0, lambda c: c, live, c)
            return c, (c[10], c[5], c[12])        # (res, cfl, flag)

        carry = (u, du, u_best, f(res_best), jnp.asarray(stall, jnp.int32),
                 f(cfl), f(cfl_cap), f(rtol), f(rtol_floor), f(raise_relres),
                 f(res), f(resold), jnp.asarray(0, jnp.int32),
                 jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
        carry, outs = jax.lax.scan(body, carry, None, length=K)
        return carry, outs

    def _pipeline_burst(self, K, mesh, u, du, u_best, res_best, stall,
                        cfl, cfl_cap, rtol, rtol_floor, raise_relres,
                        res, resold, initres, lmesh=None, mg=None,
                        ilu=None, bl=None):
        """Software-pipelined host stepping (PseudoTimeConfig.pipeline).

        Runs the SAME classic step program and the SAME controller
        arithmetic (controller_advance, as a tiny separate jitted program
        on device f64 scalars) as the single-step host loop, but dispatches
        step k+1 BEFORE fetching step k's residual: the per-step host round
        trip and the Python loop overhead
        then overlap the next step's device compute instead of serializing
        with it. Unlike the _chunk path there is no lax.scan/cond wrapping,
        so the step program keeps its exact single-step XLA fusion (and
        floating-point trajectory).

        Anomaly/convergence checks run on the fetched scalars one step
        behind the dispatch frontier; on anomaly or convergence the
        speculative in-flight step is discarded (it was never committed to
        the host view of the trajectory — the device work is wasted, the
        numbers are not). Returns (carry, outs) in exactly the _chunk
        layout so solve() shares one exit/recovery path for both."""
        cfg, lin = self.cfg, self.lin
        step_fn = self._jit("classic", lambda: jax.jit(self._step))
        # the controller program closes over cfg/lin constants, and self.cfg
        # may be swapped between solves (e.g. the two-phase bench replaces
        # cfl_init per phase): key the cache on every constant it bakes
        ctrl_fn = self._jit(
            ("ctrl", cfg.cfl_init, cfg.cfl_fin, lin.rtol_adapt,
             lin.rtol, lin.rtol_max),
            lambda: jax.jit(
                lambda c, cap, rt, fl, rr, r, ro, ir: controller_advance(
                    cfg, lin, jnp, c, cap, rt, fl, rr, r, ro, ir)))
        sd = u.dtype
        f = lambda x: jnp.asarray(x, sd)
        ctrl = (f(cfl), f(cfl_cap), f(rtol), f(rtol_floor), f(raise_relres))
        res_d, resold_d, init_d = f(res), f(resold), f(initres)
        initres_h = float(initres)
        u_cur = u
        inflight = []            # (u_prev, u_next, resj, itersj, ctrl)
        hist_res, hist_cfl = [], []
        n_done = 0
        iters_total = 0
        flag = 0
        stall = int(stall)
        res_h, resold_h = float(res), float(resold)
        best_ref, best_val = u_best, float(res_best)
        dispatched = 0
        final_u = u
        last_ctrl = ctrl         # controller scalars of the last COMMITTED
        #                          (or anomalous) step, returned to the host
        while flag == 0 and (inflight or dispatched < K):
            while dispatched < K and len(inflight) < 2:
                ctrl = ctrl_fn(*ctrl, res_d, resold_d, init_d)
                u_next, resj, itersj = step_fn(mesh, u_cur, ctrl[0],
                                               ctrl[2], 1.0, lmesh=lmesh,
                                               mg=mg, ilu=ilu, bl=bl)
                inflight.append((u_cur, u_next, resj, itersj, ctrl))
                resold_d, res_d = res_d, resj
                u_cur = u_next
                dispatched += 1
            u_prev_k, u_next_k, resj, itersj, ctrl_k = inflight.pop(0)
            rv, iv = jax.device_get((resj, itersj))
            rv = float(rv)
            iters_total += int(iv)
            last_ctrl = ctrl_k
            finite = np.isfinite(rv)
            blown = finite and rv > cfg.blowup_relres * initres_h
            if not finite or blown:
                flag = 2
                break
            if rv < best_val:
                # the residual was evaluated at u_prev_k (pre-update state)
                best_ref, best_val = u_prev_k, rv
            frozen = (abs(rv / res_h - 1.0) < 1e-12
                      and rv / initres_h > cfg.tol)
            stall = stall + 1 if frozen else 0
            resold_h, res_h = res_h, rv
            n_done += 1
            hist_res.append(rv)
            hist_cfl.append(ctrl_k[0])     # device scalar; fetched in one
            #                                tuple get at burst exit
            final_u = u_next_k
            if (rv / initres_h <= cfg.tol
                    or (cfg.tol_abs and rv <= cfg.tol_abs)):
                flag = 1
                break
            if stall >= 4:
                flag = 3
                break
        # one blocking fetch for the exit controller state + per-step CFLs
        # (already realized on device; a single tuple get is one round trip)
        ctrl_host, hist_cfl = jax.device_get((last_ctrl, tuple(hist_cfl)))
        ctrl_host = [float(x) for x in ctrl_host]
        # on anomaly (flag 2) mirror the single-step loop's accounting:
        # res = the bad value, resold = the last committed residual (the
        # recovery path may resume from `resold`)
        carry = (final_u, du, best_ref, best_val, stall,
                 ctrl_host[0], ctrl_host[1], ctrl_host[2], ctrl_host[3],
                 ctrl_host[4],
                 res_h if flag != 2 else rv,
                 resold_h if flag != 2 else res_h,
                 flag, iters_total, n_done)
        outs = (np.asarray(hist_res, dtype=np.float64),
                np.asarray(hist_cfl, dtype=np.float64),
                np.zeros(len(hist_res), dtype=np.int32))
        return carry, outs

    def solve(self, mesh, u0, log_every: int = 0, logger=None) -> tuple:
        self._lines(mesh)        # prewarm eagerly: see _lines docstring
        mg = self._mg(mesh)      # AMG hierarchy (host build, jit argument)
        ilu = self._ilu(mesh)    # ILU0 sparsity analysis (host, jit arg)
        bl = self._banded(mesh)  # band analysis (host, jit arg; None =
        #                          gather path — lin.banded only)
        warm = self.lin.warm_start
        # with warm start OFF (default) the traced step program is exactly
        # the classic 3-output step: converged regression trajectories are
        # float-sensitive, so the default program must stay bit-identical.
        # The mesh (and its precomputed f32 copy for the mixed-precision
        # Krylov phase) is a jit ARGUMENT: baking O(mesh) literals into the
        # program made program size scale with the mesh and capped usable
        # meshes at ~205k cells
        defl = self.lin.deflation_k > 0
        step_fn = (self._jit("warm", lambda: jax.jit(
                       partial(self._step, return_du=True)))
                   if warm else
                   self._jit("classic", lambda: jax.jit(self._step)))
        # GCRO-DR recycling: a separate traced program, used only below
        # deflation_start_relres (stale recycle spaces derail the violent
        # transient phase); until then the CLASSIC program runs, so gated
        # trajectories are bit-identical to the default until the gate opens
        defl_fn = (self._jit(("defl", warm), lambda: jax.jit(
            partial(self._step, return_du=warm, return_defl=True)))
            if defl else None)
        mixed = self.lin.mixed_precision and u0.dtype == jnp.float64
        lmesh = mesh.astype(jnp.float32) if mixed else mesh
        if self.cfg.bake_mesh and not warm and not defl:
            # opt-in (cfg.bake_mesh): close mesh/lmesh over the program as
            # compiled constants. Removes the per-call host marshal of the
            # mesh pytree at the price of an O(mesh)-size program (so:
            # small/medium meshes only).
            _core = self._jit(("baked", id(mesh)), lambda: jax.jit(
                lambda u, cfl, rtol, omega_cap: self._step(
                    mesh, u, cfl, rtol, omega_cap,
                    lmesh=lmesh, mg=mg, ilu=ilu, bl=bl)))
            step_fn = (lambda _m, u, cfl, rtol, omega_cap=1.0, **_kw:
                       _core(u, cfl, rtol, omega_cap))
        u = u0
        info = SolveInfo()
        t0 = time.perf_counter()
        res = resold = initres = 1.0
        cfl = self.cfg.cfl_init
        step = 0
        if logger is None and log_every:
            from ..io_config.logs import ConvergenceLogger
            logger = ConvergenceLogger(print_every=log_every,
                                       label=self.log_label)

        rtol = 0.1 if self.lin.rtol_adapt else self.lin.rtol
        rtol_floor = self.lin.rtol
        raise_relres = 0.0    # relres level of the last floor raise
        resumed_cap = 0.0

        # resume from a checkpoint if one exists (absent in the reference:
        # controlparser.hpp:24 parses init_soln_file but never implements it)
        if self.checkpoint_path:
            import os
            from ..io_config.checkpoint import load_checkpoint
            if os.path.exists(self.checkpoint_path):
                ck = load_checkpoint(self.checkpoint_path)
                u = jnp.asarray(ck["u"], dtype=u0.dtype)
                step = ck["step"]
                cfl = ck["cfl"] or cfl
                res = resold = ck["res"] or 1.0
                initres = ck["initres"] or 1.0
                # restore the full controller state so the resumed solve
                # CONTINUES the interrupted trajectory (restarting the
                # forcing controller loose deep into convergence can trap
                # a float-marginal case in a residual limit cycle)
                rtol = float(ck.get("x_rtol", rtol))
                rtol_floor = float(ck.get("x_rtol_floor", rtol_floor))
                raise_relres = float(ck.get("x_raise_relres", 0.0))
                resold = float(ck.get("x_resold", resold))
                resumed_cap = float(ck.get("x_cfl_cap", 0.0))
                print(f"  resumed from {self.checkpoint_path} at step {step}")

        nan_retries = 0
        omega_cap = 1.0
        du_prev = jnp.zeros_like(u) if warm else None
        u_good = u            # last state whose residual evaluated healthy
        u_best, res_best = u, float("inf")   # lowest-residual state seen
        stall_count = 0
        # trust-region cap, shrinks on failures (restored across resume)
        cfl_cap = resumed_cap if resumed_cap > 0 else float("inf")
        K = max(1, int(self.cfg.device_steps))
        # the chunked device-side controller implements the exp ramp only;
        # the (step-indexed) linear ramp runs through the host loop
        # keyed on the cfg/lin constants the traced chunk bakes in, since
        # self.cfg may be swapped between solves (two-phase scheduling)
        chunk_fn = (self._jit(("chunk", K, self.cfg.cfl_init,
                               self.cfg.cfl_fin, self.cfg.tol,
                               self.cfg.tol_abs, self.cfg.blowup_relres,
                               self.lin.rtol_adapt, self.lin.rtol,
                               self.lin.rtol_max),
                              lambda: jax.jit(partial(self._chunk, K)))
                    if K > 1 and self.cfg.cfl_ramp == "exp" and not defl
                    else None)
        # pipelined host stepping (cfg.pipeline): same step program, same
        # controller arithmetic, but the per-step fetch lags the dispatch
        # frontier by one step — classic/exp-ramp path only
        pipe_on = (self.cfg.pipeline and chunk_fn is None
                   and not warm and not defl
                   and self.cfg.cfl_ramp == "exp"
                   and not self.cfg.bake_mesh)
        U_defl = None           # recycled Krylov space (lin.deflation_k)
        single_left = 1         # the first step runs singly (sets initres);
        #                         recoveries also force a few single steps
        du_c = jnp.zeros_like(u)   # chunk-carried Newton direction
        while step < self.cfg.maxiter:
            if ((chunk_fn is not None or pipe_on)
                    and single_left <= 0 and step > 0):
                u_entry = u     # chunk-granular rollback fallback
                if chunk_fn is not None:
                    runner = chunk_fn
                else:
                    kb = min(self.checkpoint_every
                             if (self.checkpoint_path
                                 and self.checkpoint_every) else 50,
                             self.cfg.maxiter - step)
                    runner = partial(self._pipeline_burst, max(1, kb))
                carry, outs = runner(
                    mesh, u, du_c, u_best, res_best, stall_count,
                    cfl, cfl_cap, rtol, rtol_floor, raise_relres,
                    res, resold, initres, lmesh=lmesh, mg=mg, ilu=ilu,
                    bl=bl)
                (u, du_c, u_best, res_bestj, stallj, cflj,
                 cfl_capj, rtolj, rtol_floorj, raise_relresj, resj,
                 resoldj, flagj, itersj, nstepsj) = carry
                ((res_bestv, stall_count, cfl, cfl_cap, rtol,
                  rtol_floor, raise_relres, resv, resoldv, flag, iters_ch,
                  n_ch), (res_h, cfl_h, flag_h)) = jax.device_get(
                    ((res_bestj, stallj, cflj, cfl_capj,
                      rtolj, rtol_floorj, raise_relresj, resj, resoldj,
                      flagj, itersj, nstepsj), outs))
                res_best = float(res_bestv)
                stall_count = int(stall_count)
                cfl, cfl_cap = float(cfl), float(cfl_cap)
                rtol, rtol_floor = float(rtol), float(rtol_floor)
                raise_relres = float(raise_relres)
                res, resold = float(resv), float(resoldv)
                flag, n_ch = int(flag), int(n_ch)
                info.total_lin_iters += int(iters_ch)
                for k in range(n_ch):
                    info.history.append((step + k + 1,
                                         float(res_h[k]) / initres,
                                         float(res_h[k]), float(cfl_h[k])))
                    if logger:
                        logger.log(step + k + 1,
                                   float(res_h[k]) / initres,
                                   float(res_h[k]), cfl=float(cfl_h[k]))
                if (logger and n_ch > 0 and self.functional_fn is not None
                        and self.functional_every):
                    # burst-granular functional record (one device eval +
                    # fetch per burst, not per step; pipelining intact)
                    fv = jax.device_get(self.functional_fn(mesh, u))
                    logger.log(step + n_ch, res / initres, res, cfl=cfl,
                               **dict(zip(("entropy", "CL", "CDp", "CDsf"),
                                          (float(x) for x in fv))))
                step += n_ch
                if (self.checkpoint_path and self.checkpoint_every
                        and flag in (0, 1)):
                    from ..io_config.checkpoint import save_checkpoint
                    save_checkpoint(self.checkpoint_path, u, step=step,
                                    cfl=cfl, res=res, initres=initres,
                                    extra={"rtol": rtol,
                                           "rtol_floor": rtol_floor,
                                           "raise_relres": raise_relres,
                                           "resold": resold,
                                           "cfl_cap": min(cfl_cap, 1e300)})
                if flag == 1:            # converged inside the chunk
                    break
                if flag == 2:            # NaN or blowup: host recovery
                    nan_retries += 1
                    if nan_retries > 5:
                        raise NumericalError(
                            "implicit solve diverged: residual NaN/inf")
                    if res_best < float("inf"):
                        u = u_best
                        res = resold = res_best
                    else:
                        u = u_entry
                        res = resold
                    cfl_cap = max(cfl * 0.25, 1.0)
                    cfl = max(cfl * 0.1, 1.0)
                    rtol = rtol_floor = self.lin.rtol
                    raise_relres = 0.0
                    omega_cap = 0.2
                    du_c = jnp.zeros_like(u)
                    if du_prev is not None:
                        du_prev = jnp.zeros_like(u)
                    single_left = 5
                    print(f"  BE: chunk anomaly, retrying from "
                          f"{'best' if res_best < float('inf') else 'entry'}"
                          f" state at CFL {cfl:.1f} (retry {nan_retries}/5)")
                    continue
                if flag == 3:            # frozen residual (4x bit-identical)
                    # same response as the single-step frozen-state guard
                    stall_count = 0
                    rtol = rtol_floor = self.lin.rtol
                    cfl_cap = max(cfl * 0.25, 1.0)
                    cfl = max(cfl * 0.1, 1.0)
                    du_c = jnp.zeros_like(u)
                    single_left = 5
                    print(f"  BE: frozen residual in chunk, dropping to CFL "
                          f"{cfl:.1f} with tight linear solves")
                    continue
                nan_retries = 0          # full healthy chunk
                omega_cap = 1.0
                continue
            single_left -= 1
            if step > 0:
                rc = (linear_ramp(self.cfg.cfl_init, self.cfg.cfl_fin,
                                  self.cfg.rampstart, self.cfg.rampend,
                                  step)
                      if self.cfg.cfl_ramp == "linear" else None)
                cfl, cfl_cap, rtol, rtol_floor, raise_relres = [
                    float(x) for x in controller_advance(
                        self.cfg, self.lin, np, cfl, cfl_cap, rtol,
                        rtol_floor, raise_relres, res, resold, initres,
                        ramped_cfl=rc)]
            u_prev = u
            defl_on = (defl and step > 0
                       and res <= self.lin.deflation_start_relres * initres)
            if not defl_on:
                U_defl = None     # space from before a recovery/gate-close
            td = time.perf_counter()
            if defl_on and warm:
                u, resj, itersj, du_prev, U_defl = defl_fn(
                    mesh, u, cfl, rtol, omega_cap, du_prev,
                    lmesh=lmesh, mg=mg, U0=U_defl, ilu=ilu, bl=bl)
            elif defl_on:
                u, resj, itersj, U_defl = defl_fn(mesh, u, cfl, rtol,
                                                  omega_cap, lmesh=lmesh,
                                                  mg=mg, U0=U_defl, ilu=ilu,
                                                  bl=bl)
            elif warm:
                u, resj, itersj, du_prev = step_fn(mesh, u, cfl, rtol,
                                                   omega_cap, du_prev,
                                                   lmesh=lmesh, mg=mg,
                                                   ilu=ilu, bl=bl)
            else:
                u, resj, itersj = step_fn(mesh, u, cfl, rtol, omega_cap,
                                          lmesh=lmesh, mg=mg, ilu=ilu,
                                          bl=bl)
            resold = res
            # device functional evaluation joins the step's fused fetch
            fnl_j = None
            if (self.functional_fn is not None and self.functional_every
                    and (step + 1) % self.functional_every == 0):
                fnl_j = self.functional_fn(mesh, u)
            tf = time.perf_counter()
            info.t_dispatch += tf - td
            # ONE fused device fetch (a tuple get is a single host round
            # trip; two separate gets cost two)
            if fnl_j is not None:
                res_v, iters_v, fnl_v = jax.device_get((resj, itersj, fnl_j))
                fnl_log = dict(zip(("entropy", "CL", "CDp", "CDsf"),
                                   (float(x) for x in fnl_v)))
            else:
                res_v, iters_v = jax.device_get((resj, itersj))
                fnl_log = {}
            res = float(res_v)
            info.total_lin_iters += int(iters_v)
            tz = time.perf_counter()
            info.t_fetch += tz - tf
            info.step_times.append((tf - td, tz - tf, int(iters_v)))
            finite = np.isfinite(res)
            # numerical blowup: finite residual but far beyond any physical
            # transient (shock-formation transients peak ~1e2-1e3 x initres;
            # 1e5+ means the continuation left the basin entirely)
            blown = (finite and step > 0
                     and res > self.cfg.blowup_relres * initres)
            if finite and not blown:
                # the residual was evaluated at u_prev: u_prev is certified
                u_good = u_prev
                if res < res_best:
                    u_best, res_best = u_prev, res
                nan_retries = 0
                omega_cap = 1.0
            if not finite or blown:
                # divergence guard (beyond the reference, which throws on
                # NaN and accepts any finite residual): back off at a much
                # smaller CFL. NaN retries resume locally (u_good); blowups
                # restart from the best-seen state, since every state on
                # the divergent branch is polluted.
                nan_retries += 1
                if nan_retries > 5:
                    raise NumericalError(
                        "implicit solve diverged: residual NaN/inf")
                if blown and res_best < float("inf"):
                    u = u_best
                    res = resold = res_best
                else:
                    u = u_good
                    res = resold
                # shrink the trust region: cap future CFL well below the
                # failure level (it re-expands 5%/step on success)
                cfl_cap = max(cfl * 0.25, 1.0)
                cfl = max(cfl * 0.1, 1.0)
                if blown:
                    # blowups are fed by too-loose linear solves during the
                    # shock phase: reset the forcing ratchet and solve tight
                    rtol = rtol_floor = self.lin.rtol
                else:
                    rtol = self.lin.rtol_max
                omega_cap = 0.2        # heavily damped recovery steps
                if du_prev is not None:
                    du_prev = jnp.zeros_like(u)   # drop the stale guess
                U_defl = None          # drop the stale recycle space
                kind = "blowup" if blown else "NaN residual"
                print(f"  BE: {kind}, retrying from "
                      f"{'best' if blown else 'previous'} state at CFL "
                      f"{cfl:.1f}, omega<=0.2 (retry {nan_retries}/5)")
                continue
            # frozen-state guard: a bit-identical residual means the update
            # was fully rejected (e.g. the positivity line search zeroed a
            # garbage Krylov direction at too-high CFL for f32): cut CFL
            # and tighten the linear solves, else the solve spins forever
            if (step > 0 and resold > 0.0
                    and abs(res / resold - 1.0) < 1e-12
                    and res / initres > self.cfg.tol):
                stall_count += 1
                if stall_count >= 4:
                    cfl_cap = max(cfl * 0.25, 1.0)
                    cfl = max(cfl * 0.1, 1.0)
                    rtol = rtol_floor = self.lin.rtol
                    stall_count = 0
                    U_defl = None      # drop the stale recycle space
                    print(f"  BE: frozen residual, dropping to CFL "
                          f"{cfl:.1f} with tight linear solves")
            else:
                stall_count = 0
            if step == 0:
                initres = res
                resold = res
            step += 1
            info.history.append((step, res / initres, res, cfl))
            if logger:
                logger.log(step, res / initres, res,
                           lin_iters=int(iters_v), cfl=cfl, **fnl_log)
            if (self.checkpoint_path and self.checkpoint_every
                    and step % self.checkpoint_every == 0):
                from ..io_config.checkpoint import save_checkpoint
                save_checkpoint(self.checkpoint_path, u, step=step, cfl=cfl,
                                res=res, initres=initres,
                                extra={"rtol": rtol,
                                       "rtol_floor": rtol_floor,
                                       "raise_relres": raise_relres,
                                       "resold": resold,
                                       "cfl_cap": min(cfl_cap, 1e300)})
            if (res / initres <= self.cfg.tol
                    or (self.cfg.tol_abs and res <= self.cfg.tol_abs)):
                break
        info.walltime = time.perf_counter() - t0
        info.steps = step
        info.initres = initres
        info.finalres = res
        info.converged = (res / initres <= self.cfg.tol
                          or bool(self.cfg.tol_abs
                                  and res <= self.cfg.tol_abs))
        if not info.converged:
            raise ToleranceError("implicit steady solve did not converge")
        return u, info
