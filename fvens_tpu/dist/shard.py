"""Multi-chip SPMD execution of the flow solver via jax.shard_map.

The reference's MPI layer (ghosted PETSc Vecs + L2TraceVector Isend/Irecv +
MPI_Allreduce, SURVEY.md sec 2.9) maps to:

  forward halo INSERT  -> all_gather of packed boundary-cell buffers
                          over the device interconnect
                          + static gather into local halo slots
  reverse halo ADD     -> unnecessary: cross-partition faces are computed
                          redundantly by both owners (like the reference's
                          connectivity faces, flow_spatial.cpp:499-502)
  MPI_Allreduce norms  -> jax.lax.psum

State u is (D, NC_local, V) sharded on the leading device axis; each device
runs the SAME single-mesh kernels on its local slab.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..solver.steady import SteadyBackwardEuler
from ..solver.precision import einsum
from .partition import ShardedMeshBundle

AXIS = "mesh_x"


def halo_exchange(bundle_local, field, axis=AXIS):
    """Fill halo cell slots of `field` (NC_local, ...) from remote owners
    via R rounds of neighbour ppermute (each round a partial permutation
    over the device axis; see partition._neighbor_schedule). Per-device
    traffic is O(local partition boundary), not O(D).

    bundle_local: (pp_send, pp_recv) per-device slices + static pp_perms.
    """
    pp_send, pp_recv, perms = bundle_local
    for r, perm in enumerate(perms):
        if not perm:
            continue
        buf = field[pp_send[r]]                     # (max_pair, ...)
        rbuf = jax.lax.ppermute(buf, axis, perm)
        field = field.at[pp_recv[r]].set(rbuf, mode="drop")
    return field


def halo_exchange_allgather(bundle_local, field, axis=AXIS):
    """All-gather halo variant (kept for A/B validation of the ppermute
    schedule and as a fallback): every device receives every other's packed
    send buffer."""
    send_idx, halo_slots, halo_src = bundle_local
    buf = field[send_idx]                               # (max_send, V)
    allbuf = jax.lax.all_gather(buf, axis)              # (D, max_send, V)
    flat = allbuf.reshape((-1,) + field.shape[1:])
    # pad slots are NC_local (out of bounds): dropped, not written
    return field.at[halo_slots].set(flat[halo_src], mode="drop")


@dataclasses.dataclass
class ShardedFlow:
    """Distributed-flow executor over a 1-D jax device mesh.

    space: a FlowFV built for the case (single-mesh functions reused as-is).
    """
    space: object
    bundle: ShardedMeshBundle
    devices: list

    def __post_init__(self):
        self.jmesh = Mesh(self.devices, (AXIS,))
        self.n_parts = self.bundle.n_parts

    # ---- sharded primitives ------------------------------------------------
    def _local_residual(self, mesh_loc, exch, u_loc, gettimesteps=True):
        """One device's residual = the single-chip pipeline with the halo
        hook threaded in (FlowFV.compute_residual(exchange=...)): u is
        exchanged up front, gradients are re-exchanged inside face_states
        (the reference's VecGhostUpdate on gradvec,
        flow_spatial.cpp:710-729)."""
        u_loc = halo_exchange(exch, u_loc)
        ex = partial(halo_exchange, exch)
        rhs, dt = self.space.compute_residual(
            mesh_loc, u_loc, gettimesteps, exchange=ex)
        return u_loc, rhs, dt

    def _exch(self, pps, ppr):
        """Per-device exchange context from shard_map operands (leading
        device axis already sliced to 1)."""
        return (pps[0], ppr[0], self.bundle.pp_perms)

    def residual(self, u):
        """Global sharded residual: u (D, NC_local, V)."""
        b = self.bundle

        def body(mesh_st, pps, ppr, u_loc):
            mesh_loc = jax.tree_util.tree_map(lambda x: x[0], mesh_st)
            _, rhs, dt = self._local_residual(
                mesh_loc, self._exch(pps, ppr), u_loc[0])
            return rhs[None], dt[None]

        return jax.shard_map(
            body, mesh=self.jmesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(AXIS)),
        )(b.mesh, b.pp_send, b.pp_recv, u)

    def fe_step_fn(self, cfl: float):
        """Jittable explicit forward-Euler step over the device mesh:
        returns (u', global residual norm)."""
        b = self.bundle

        def body(mesh_st, pps, ppr, u_loc):
            mesh_loc = jax.tree_util.tree_map(lambda x: x[0], mesh_st)
            exch = self._exch(pps, ppr)
            u1, rhs, dt = self._local_residual(mesh_loc, exch, u_loc[0])
            unew = u1 + (cfl * dt * mesh_loc.inv_area)[:, None] * rhs
            r = rhs[:, -1]
            loc = ((r * r) * mesh_loc.area * mesh_loc.cell_mask).sum()
            res = jnp.sqrt(jax.lax.psum(loc, AXIS))
            return unew[None], res

        def step(u):
            return jax.shard_map(
                body, mesh=self.jmesh,
                in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
                out_specs=(P(AXIS), P()),
            )(b.mesh, b.pp_send, b.pp_recv, u)

        return jax.jit(step)


    # ---- distributed implicit (backward Euler) step -------------------------
    def be_step_fn(self, lin=None, nl=None):
        """Jittable distributed implicit pseudo-time step.

        Structure mirrors the single-chip SteadyBackwardEuler._step with the
        reference's parallel layout (PETSc bjacobi: Schwarz across ranks,
        strong smoother within): per shard local Jacobian + multicolor SGS
        preconditioner with zero halo coupling; the GMRES matvec halo-
        exchanges the Krylov vector every application; dot products psum.
        Returns step(u, cfl, rtol) -> (u', global res norm, lin iters).
        """
        from ..config import LinearSolverConfig, NonlinearUpdateConfig
        from ..solver import jacobian as jacmod
        from ..solver.linear import (gmres, make_bsr_matvec,
                                     make_preconditioner)
        from ..solver.relaxation import get_update_scheme
        from ..solver.steady import residual_norm
        lin = lin or LinearSolverConfig()
        nl = nl or NonlinearUpdateConfig()
        b = self.bundle
        space = self.space

        def body(mesh_st, pps, ppr, u_sh, cfl, rtol):
            mesh_loc = jax.tree_util.tree_map(lambda x: x[0], mesh_st)
            exch = self._exch(pps, ppr)
            mask = mesh_loc.cell_mask[:, None]

            u_loc, rhs, dt = self._local_residual(mesh_loc, exch, u_sh[0])
            jac = space.assemble_jacobian(mesh_loc, u_loc)
            jac = jacmod.add_pseudotime_term(mesh_loc, jac, cfl, dt)

            # shard-local preconditioner (additive Schwarz, no halo coupling)
            pc = make_preconditioner(mesh_loc, jac, lin.pc, lin.pc_sweeps)

            mv_loc = make_bsr_matvec(mesh_loc, jac)  # fused operand, built
            #                                          once per Newton step

            def matvec(x):
                xh = halo_exchange(exch, x)
                return mv_loc(xh) * mask

            du, iters, relres = gmres(
                matvec, rhs * mask, jnp.zeros_like(rhs),
                lambda v: pc(v) * mask,
                restart=lin.restart, maxiter=lin.maxiter, rtol=rtol,
                axis_name=AXIS)

            omega = get_update_scheme(nl.scheme)(
                getattr(space, "phy", None), u_loc, du, nl.min_factor)
            unew = u_loc + omega[:, None] * du * mask

            loc = ((rhs[:, -1] ** 2) * mesh_loc.area * mesh_loc.cell_mask).sum()
            res = jnp.sqrt(jax.lax.psum(loc, AXIS))
            ok = (jnp.isfinite(rhs).all() & jnp.isfinite(unew).all()
                  & jnp.isfinite(relres))
            ok = jax.lax.pmin(jnp.where(ok, 1, 0), AXIS) > 0
            res = jnp.where(ok, res, jnp.nan)
            return unew[None], res, iters

        def step(u, cfl, rtol):
            return jax.shard_map(
                body, mesh=self.jmesh,
                in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P()),
                out_specs=(P(AXIS), P(), P()),
            )(b.mesh, b.pp_send, b.pp_recv, u,
              jnp.asarray(cfl), jnp.asarray(rtol))

        return jax.jit(step)

    def solve_implicit(self, cfg, lin=None, nl=None, u=None,
                       log_every: int = 0, logger=None,
                       checkpoint_path=None, checkpoint_every: int = 50):
        """Distributed steady implicit solve at single-chip controller
        parity: the FULL SteadyBackwardEuler host controller (exp/linear CFL
        ramp + trust-region cap, Krylov forcing controller, NaN/blowup
        recovery from the best-seen state, frozen-residual guard,
        checkpoint/resume, mixed precision) drives shard_map'ed implicit
        steps — see DistributedBackwardEuler. cfg: PseudoTimeConfig."""
        from ..config import LinearSolverConfig, NonlinearUpdateConfig
        be = DistributedBackwardEuler(
            space=self.space, cfg=cfg, lin=lin or LinearSolverConfig(),
            nl=nl or NonlinearUpdateConfig(), checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, flow=self)
        if u is None:
            u = self.initial_state()
        b = self.bundle
        dmesh = DistMesh(b.mesh, b.pp_send, b.pp_recv)
        return be.solve(dmesh, u, log_every=log_every, logger=logger)

    def initial_state(self):
        u0 = jnp.tile(self.space.uinf.astype(self.bundle.mesh.dtype),
                      (self.n_parts, self.bundle.mesh.NC, 1))
        return jax.device_put(
            u0, jax.sharding.NamedSharding(self.jmesh, P(AXIS)))

    def dist_mesh(self):
        """The DistMesh pytree handle fed to DistributedBackwardEuler."""
        b = self.bundle
        return DistMesh(b.mesh, b.pp_send, b.pp_recv)

    def gather_solution(self, u):
        """(D, NC_local, V) -> (n_cells_global, V) in global cell order."""
        import numpy as np
        b = self.bundle
        out = np.zeros((b.n_cells_global, u.shape[-1]))
        u_np = np.asarray(u)
        gid = np.asarray(b.own_gid)
        for p in range(b.n_parts):
            n_own = int(b.own_counts[p])
            out[gid[p, :n_own]] = u_np[p, :n_own]
        return out


@partial(jax.tree_util.register_dataclass,
         data_fields=["mesh", "pp_send", "pp_recv"], meta_fields=[])
@dataclasses.dataclass
class DistMesh:
    """Pytree handle standing in for CompiledMesh in the inherited
    SteadyBackwardEuler.solve host loop: carries the stacked per-part mesh
    plus the ppermute exchange maps, and supports the one mesh operation
    the host loop performs (astype for the mixed-precision f32 copy)."""
    mesh: object                  # CompiledMesh, every leaf stacked (D, ...)
    pp_send: jnp.ndarray          # (D, R, max_pair)
    pp_recv: jnp.ndarray          # (D, R, max_pair)

    def astype(self, dtype):
        return DistMesh(self.mesh.astype(dtype), self.pp_send, self.pp_recv)


@dataclasses.dataclass
class DistributedBackwardEuler(SteadyBackwardEuler):
    """Distributed implicit solver at single-chip parity.

    REUSES the SteadyBackwardEuler host controller by inheritance — the
    exp/linear CFL ramp + trust-region cap, the Krylov forcing controller
    (one shared controller_advance), NaN/blowup recovery from the
    best-seen state, the frozen-residual guard, checkpoint/resume with
    full controller state, and mixed precision all come from solve()
    unchanged — and overrides ONLY the device step with a shard_map'ed
    program: halo-exchanged residual, per-shard Jacobian, additive-Schwarz
    preconditioner (the reference's parallel bjacobi layout,
    testcases/defaults.solverc:16-19), psum-GMRES, positivity line search.

    The reference treats MPI implicit solves as first-class
    (tests/inv-2dcyl/CMakeLists.txt:31-37); its recovery logic, however,
    is single-rank-identical by SPMD construction — same here: every
    host-side controller decision is driven by psum'd global scalars, so
    all shards take identical control paths.
    """
    flow: ShardedFlow = None

    log_label = "dBE"

    def __post_init__(self):
        if self.lin.pc in ("bline", "amg"):
            raise NotImplementedError(
                f"pc={self.lin.pc!r} has no distributed form (stacking the "
                "per-part line/hierarchy structures needs cross-part shape "
                "padding, and neither has beaten bsgs on a single "
                "device); use bjacobi/bsgs/bcsgs/ilu0 "
                "(shard-local additive Schwarz), optionally banded, "
                "matrix-free, warm_start or deflation_k")
        if self.cfg.device_steps > 1:
            raise NotImplementedError(
                "device-side chunked stepping (device_steps>1) is "
                "single-chip only; the distributed step is already one "
                "device program per pseudo-time step")

    # pc-specific host caches don't apply to the supported distributed pcs
    def _lines(self, mesh):
        return None

    def _mg(self, mesh):
        return None

    def _banded(self, dmesh):
        """Per-part band analysis (lin.banded): one shared static offsets
        tuple over a stacked per-shard BandedStructure, with seam/halo
        couplings in the compact rest lists (banded_structure_parts).
        None (gather path) when the partitioned mesh is not band-dominant."""
        if not self.lin.banded:
            return None
        cache = getattr(self, "_banded_cache", None)
        key = id(dmesh)
        if cache is None or cache[0] != key:
            import numpy as np
            from ..solver.banded import banded_structure_parts
            m = dmesh.mesh
            self._banded_cache = (key, banded_structure_parts(
                np.asarray(m.cell_nbrs), np.asarray(m.nbr_mask)))
        return self._banded_cache[1]

    def _ilu(self, dmesh):
        """Per-part ILU0 sparsity analysis (pc='ilu0'): one ILUStructure
        per shard-local mesh, stacked on the device axis — the local half
        of the reference's parallel bjacobi+ILU0 default."""
        if self.lin.pc != "ilu0":
            return None
        cache = getattr(self, "_ilu_cache", None)
        key = id(dmesh)
        if cache is None or cache[0] != key:
            from ..solver.ilu import ILUStructure, ilu_structure
            mesh_st = dmesh.mesh
            D = mesh_st.cell_nbrs.shape[0]
            parts = [ilu_structure(jax.tree_util.tree_map(
                lambda x, p=p: x[p], mesh_st)) for p in range(D)]
            stacked = ILUStructure(*[
                jnp.stack([getattr(s, f) for s in parts])
                for f in ILUStructure._fields])
            self._ilu_cache = (key, stacked)
        return self._ilu_cache[1]

    def _step(self, dmesh, u, cfl, rtol, omega_cap=1.0, du0=None,
              return_du=False, lmesh=None, mg=None, U0=None,
              return_defl=False, ilu=None, bl=None):
        """Distributed analogue of SteadyBackwardEuler._step with the SAME
        contract: (mesh-arg, u, cfl, rtol, omega_cap) -> (u', global res,
        iters) [+ du], so the inherited host loop drives it unchanged.
        u is (D, NC_local, V) sharded on the leading device axis."""
        from ..solver import jacobian as jacmod
        from ..solver.linear import (gmres, gmres_dr, make_bsr_matvec,
                                     make_preconditioner)
        from ..solver.relaxation import get_update_scheme
        flow, space, lin, nl = self.flow, self.space, self.lin, self.nl
        defl = return_defl
        have_U0 = U0 is not None
        warm = du0 is not None
        mixed = lin.mixed_precision and u.dtype == jnp.float64
        lm = lmesh if (mixed and lmesh is not None) else dmesh
        # banded (shifted-slice) encoding: same eligibility rule as the
        # single-chip step (steady.py banded_on)
        banded_on = (bl is not None and not lin.matrix_free
                     and lin.pc in ("bjacobi", "bsgs"))
        bl_arg = bl if banded_on else None

        def body(mesh_st, lmesh_st, pps, ppr, u_sh, du0_sh, U0_st, ilu_st,
                 bl_st, cflj, rtolj, ocap):
            mesh_loc = jax.tree_util.tree_map(lambda x: x[0], mesh_st)
            exch = flow._exch(pps, ppr)
            ex = partial(halo_exchange, exch)
            u_loc = halo_exchange(exch, u_sh[0])
            rhs, dt = space.compute_residual(mesh_loc, u_loc, True,
                                             exchange=ex)

            if mixed:
                lmesh_loc = jax.tree_util.tree_map(lambda x: x[0], lmesh_st)
                lu = u_loc.astype(jnp.float32)
                lrhs = rhs.astype(jnp.float32)
                lcfl = jnp.asarray(cflj, jnp.float32)
                ldt = dt.astype(jnp.float32)
            else:
                lmesh_loc, lu, lrhs = mesh_loc, u_loc, rhs
                lcfl, ldt = cflj, dt
            mask = lmesh_loc.cell_mask[:, None].astype(lrhs.dtype)

            jac = space.assemble_jacobian(lmesh_loc, lu)
            jac = jacmod.add_pseudotime_term(lmesh_loc, jac, lcfl, ldt)
            # shard-local preconditioner = additive Schwarz — for
            # pc='ilu0' exactly the reference's parallel default layout,
            # per-rank bjacobi with a local ILU0 (defaults.solverc:16-19)
            ilu_loc = (jax.tree_util.tree_map(lambda x: x[0], ilu_st)
                       if lin.pc == "ilu0" else None)
            if banded_on:
                # per-shard banded operators: interior couplings as K
                # contiguous rolls, seam/halo couplings through the compact
                # rest scatter (solver/banded.py) — row-by-row equal to the
                # gather operators up to neighbour summation order
                from ..solver.banded import (banded_dn_blocks,
                                             make_banded_bsgs,
                                             rest_dn_blocks)
                from ..solver.linear import block_jacobi_inverse
                bl_loc = jax.tree_util.tree_map(lambda x: x[0], bl_st)
                Dinv_b = block_jacobi_inverse(jac.D)
                if lin.pc == "bjacobi":
                    pc = lambda v: einsum("cij,cj->ci", Dinv_b, v)
                else:
                    pc = make_banded_bsgs(
                        Dinv_b, banded_dn_blocks(bl_loc, Dinv_b, jac.N),
                        bl_loc.offsets, lin.pc_sweeps, bl=bl_loc,
                        DNr=rest_dn_blocks(bl_loc, Dinv_b, jac.N))
            else:
                pc = make_preconditioner(lmesh_loc, jac, lin.pc,
                                         lin.pc_sweeps, ilu=ilu_loc,
                                         ilu_setup=lin.ilu_setup_sweeps)

            if lin.matrix_free:
                # distributed matrix-free matvec (the reference's parallel
                # MATSHELL: testmatrixfree.cpp runs under MPIEXEC;
                # alinalg.cpp:124-233): halo-exchange the Krylov vector,
                # then one residual evaluation per application — the
                # residual's internal gradient halo rounds ride the same
                # `ex` hook. The preconditioner stays the assembled
                # shard-local Jacobian (user-doc.md:22-24). Runs in u's
                # precision like the single-chip path (steady.py).
                fmask = mesh_loc.cell_mask[:, None]
                diag = (mesh_loc.area / (cflj * dt)
                        * mesh_loc.cell_mask)[:, None]
                if lin.matrix_free_fd:
                    eps0 = lin.fd_eps

                    def matvec(x):
                        # reference FD shell: perturbation eps/||x|| with
                        # the GLOBAL norm (MPI_Allreduce -> psum)
                        xh = halo_exchange(exch, x)
                        nrm2 = jax.lax.psum(((x * fmask) ** 2).sum(), AXIS)
                        p = eps0 / jnp.maximum(jnp.sqrt(nrm2), 1e-300)
                        rp = space.compute_residual(
                            mesh_loc, u_loc + p * xh, False, exchange=ex)[0]
                        return (diag * x - (rp - rhs) / p) * fmask
                else:
                    def matvec(x):
                        # exact JVP of -rhs plus the pseudo-time diagonal
                        xh = halo_exchange(exch, x)
                        _, tang = jax.jvp(
                            lambda v: space.compute_residual(
                                mesh_loc, v, False, exchange=ex)[0],
                            (u_loc,), (xh,))
                        return (diag * x - tang) * fmask
            elif banded_on:
                from ..solver.banded import (banded_blocks,
                                             make_banded_matvec, rest_blocks)
                mv_loc = make_banded_matvec(
                    jac.D, banded_blocks(bl_loc, jac.N), bl_loc.offsets,
                    bl=bl_loc, R=rest_blocks(bl_loc, jac.N))

                def matvec(x):
                    return mv_loc(halo_exchange(exch, x)) * mask
            else:
                mv_loc = make_bsr_matvec(lmesh_loc, jac)

                def matvec(x):
                    # Krylov vector halo-exchanged every application — the
                    # reference's VecGhostUpdate inside each MatMult
                    return mv_loc(halo_exchange(exch, x)) * mask

            if warm:
                x0 = du0_sh[0].astype(lrhs.dtype)
                x0 = jnp.where(jnp.isfinite(x0).all(), x0,
                               jnp.zeros_like(x0))
            else:
                x0 = jnp.zeros_like(lrhs)
            if defl:
                # GCRO-DR over the device axis (axis-aware projections +
                # Cholesky-QR in gmres_dr): the recycled directions are
                # sharded like u and carried by the inherited host loop
                U_loc = U0_st[0].astype(lrhs.dtype) if have_U0 else None
                du, iters, relres, U_new = gmres_dr(
                    matvec, lrhs * mask, x0, lambda v: pc(v) * mask,
                    U=U_loc, k=lin.deflation_k, restart=lin.restart,
                    maxiter=lin.maxiter, rtol=rtolj, axis_name=AXIS)
            else:
                du, iters, relres = gmres(
                    matvec, lrhs * mask, x0, lambda v: pc(v) * mask,
                    restart=lin.restart, maxiter=lin.maxiter, rtol=rtolj,
                    axis_name=AXIS)
            if mixed:
                du = du.astype(u_loc.dtype)

            omega = get_update_scheme(nl.scheme)(
                getattr(space, "phy", None), u_loc, du, nl.min_factor)
            omega = jnp.minimum(omega, ocap)
            phy = getattr(space, "phy", None)
            if phy is not None and u_loc.shape[-1] == 4:
                # same per-cell positivity line search as the single-chip
                # step (purely cell-local: shards apply it independently)
                rho0 = u_loc[:, 0]
                p0 = phy.pressure(u_loc)

                def positive(om):
                    ut = u_loc + (omega * om)[:, None] * du
                    return ((ut[:, 0] > 0.01 * rho0)
                            & (phy.pressure(ut) > 0.01 * p0))

                scale = jnp.zeros_like(omega)
                for om in (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125):
                    scale = jnp.where((scale == 0.0) & positive(om), om,
                                      scale)
                omega = omega * scale
            unew = u_loc + omega[:, None] * du * mesh_loc.cell_mask[:, None]

            loc = ((rhs[:, -1] ** 2) * mesh_loc.area
                   * mesh_loc.cell_mask).sum()
            res = jnp.sqrt(jax.lax.psum(loc, AXIS))
            ok = (jnp.isfinite(rhs).all() & jnp.isfinite(unew).all()
                  & jnp.isfinite(relres) & jnp.isfinite(du).all())
            ok = jax.lax.pmin(jnp.where(ok, 1, 0), AXIS) > 0
            res = jnp.where(ok, res, jnp.nan)
            outs = (unew[None], res, iters)
            if return_du:
                outs = outs + (du[None],)
            if defl:
                outs = outs + (U_new[None],)
            return outs

        out_specs = (P(AXIS), P(), P())
        if return_du:
            out_specs = out_specs + (P(AXIS),)
        if defl:
            out_specs = out_specs + (P(AXIS),)
        du0_arg = du0 if warm else u    # dummy, sliced but unused
        U0_arg = U0 if have_U0 else u   # dummy, sliced but unused
        # pc='ilu0': the stacked per-part ILUStructure rides the device
        # axis; for other pcs pass the (leafless) None pytree — same rule
        # for the stacked per-part BandedStructure
        ilu_arg = ilu if self.lin.pc == "ilu0" else None
        ilu_spec = (jax.tree_util.tree_map(lambda _: P(AXIS), ilu_arg)
                    if ilu_arg is not None else None)
        bl_spec = (jax.tree_util.tree_map(lambda _: P(AXIS), bl_arg)
                   if bl_arg is not None else None)
        return jax.shard_map(
            body, mesh=flow.jmesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                      P(AXIS), ilu_spec, bl_spec, P(), P(), P()),
            out_specs=out_specs,
        )(dmesh.mesh, lm.mesh, dmesh.pp_send, dmesh.pp_recv, u, du0_arg,
          U0_arg, ilu_arg, bl_arg, jnp.asarray(cfl), jnp.asarray(rtol),
          jnp.asarray(omega_cap))
