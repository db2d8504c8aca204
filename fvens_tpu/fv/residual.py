"""The flow residual: one fused gather -> pointwise -> gather-sum pipeline.

Data-parallel rewrite of FlowFV::compute_residual (FVENS
src/spatial/flow_spatial.cpp:636-816), preserving the reference's exact
operation order for second-order accuracy:

  cell conserved -> boundary ghost states (BCs) -> primitive variables ->
  cell gradients (of primitives) -> (limited) reconstruction in primitives ->
  face states back to conserved -> flux-side boundary ghosts -> face fluxes
  (inviscid + viscous) -> signed incidence sums into cells -> local timesteps.

Sign convention matches the reference: the assembled array is the NEGATIVE
flux divergence, i.e. `rhs` in  Vol du/dt = rhs  (flow_spatial.cpp:551-561).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import NumericsConfig, PhysicsConfig
from ..physics.gas import GasPhysics
from . import bcs
from .fluxes import get_flux
from .gradients import get_gradient_scheme
from .reconstruction import (cell_limited_gradients, extrapolate_faces,
                             get_reconstruction)
from .viscous import (modified_average_gradient, prim2_states_and_gradients,
                      viscous_face_flux)


@dataclasses.dataclass(frozen=True)
class FlowFV:
    """The spatial discretization: static configuration + pure functions.

    Equivalent of FlowFV<scalar, order2, constVisc> (flow_spatial.hpp:174-320).
    """
    phy: GasPhysics
    pcfg: PhysicsConfig
    ncfg: NumericsConfig

    def __post_init__(self):
        get_flux(self.ncfg.flux)  # validate early

    # -- pieces ---------------------------------------------------------------
    @property
    def uinf(self):
        return self.phy.freestream_state(self.pcfg.aoa)

    def ghost_states(self, mesh, u):
        """Conserved ghost cell-centre states at physical boundary faces."""
        return bcs.compute_ghost_states(self.phy, mesh, u, self.uinf)

    def gradients(self, mesh, w, wg):
        return get_gradient_scheme(self.ncfg.gradient)(mesh, w, wg)

    def _inviscid_face_flux(self, uL, uR, normals):
        f = get_flux(self.ncfg.flux)
        return jax.vmap(lambda a, b, n: f(self.phy, a, b, n))(uL, uR, normals)

    # -- face states ------------------------------------------------------------
    def face_states(self, mesh, u, exchange=None):
        """Returns (uL, uR, ug_cell, grads) with uL/uR (NF,4) conserved face
        states (flux-ready, incl. boundary ghosts on the right), ug_cell
        (NB,4) the conserved boundary ghost CELL states, and grads (NC,2,4)
        primitive gradients (zeros for first order).

        `exchange`, when given, is a halo-exchange hook `(NC,...) -> (NC,...)`
        filling this shard's halo cell slots from their remote owners. It is
        applied to the cell gradients (the reference's VecGhostUpdate on
        gradvec, flow_spatial.cpp:710-729); `u` itself must arrive already
        exchanged. This keeps the distributed residual (dist/shard.py) on
        the exact single-chip pipeline instead of a parallel fork.
        """
        nb = mesh.n_bfaces
        phy = self.phy

        if self.ncfg.order2:
            ug_cell = self.ghost_states(mesh, u)            # conserved (NB,4)
            up = phy.primitive_from_conserved(u)            # (NC,4)
            ugp = phy.primitive_from_conserved(ug_cell)     # (NB,4)

            grads = self.gradients(mesh, up, ugp)
            if exchange is not None:
                # halo cells' gradients computed locally are wrong (their
                # stencils are incomplete); overwrite from the owning shard
                grads = exchange(grads)
            rname = (self.ncfg.reconstruction
                     if self.ncfg.reconstruction != "NONE" else "LINEAR")
            lgrad = cell_limited_gradients(mesh, up, ugp, grads, rname,
                                           self.ncfg.limiter_param)
            if lgrad is not None:
                if exchange is not None and rname not in ("LINEAR",):
                    # limiter/WENO weights also read neighbour stencils:
                    # halo cells' limited gradients must come from the owner
                    lgrad = exchange(lgrad)
                wL, wR = extrapolate_faces(mesh, up, lgrad)
            else:
                # face-based reconstruction (MUSCL-VanAlbada): needs only
                # the two adjacent cells' grads, which are exchanged above
                recon = get_reconstruction(rname)
                wL, wR = recon(mesh, up, ugp, grads, self.ncfg.limiter_param)
            # positivity safeguard: where reconstruction overshoots into
            # negative density/pressure (possible at strong shocks even with
            # limiters), fall back to the first-order cell value at that
            # face side; every flux takes sqrt(p), so unphysical face states
            # would otherwise NaN the whole residual
            wl_cell = up[mesh.f_left]
            wr_cell = up[mesh.f_right]
            badL = ((wL[:, 0] <= 0.0) | (wL[:, 3] <= 0.0))[:, None]
            badR = ((wR[:, 0] <= 0.0) | (wR[:, 3] <= 0.0))[:, None]
            wL = jnp.where(badL, wl_cell, wL)
            wR = jnp.where(badR, wr_cell, wR)
            uL = phy.conserved_from_primitive(wL)
            uR = phy.conserved_from_primitive(wR)
        else:
            ug_cell = None
            grads = jnp.zeros((mesh.NC, 2, 4), dtype=u.dtype)
            uL = u[mesh.f_left]
            uR = u[mesh.f_right]

        # flux-side ghost states at physical boundaries from the (possibly
        # reconstructed) left face state (flow_spatial.cpp:777-778).
        # Periodic faces keep the reconstructed right state from the partner
        # cell at the partner face midpoint (2nd-order periodic coupling).
        ug_flux = bcs.ghost_state(phy, uL[:nb], mesh.f_normal[:nb],
                                  mesh.bc_code, mesh.bc_v0, mesh.bc_v1,
                                  self.uinf, u_partner=u[mesh.f_right[:nb]])
        if self.ncfg.order2:
            from ..config import BC_PERIODIC
            keep = (mesh.bc_code == BC_PERIODIC)[:, None]
            ug_flux = jnp.where(keep, uR[:nb], ug_flux)
        uR = uR.at[:nb].set(ug_flux)
        if ug_cell is None:
            ug_cell = ug_flux
        return uL, uR, ug_cell, grads

    # -- the residual -----------------------------------------------------------
    def compute_residual(self, mesh, u, gettimesteps: bool = True,
                         exchange=None):
        """rhs (NC,4) = - sum_faces flux*len (signed); dt (NC,) local steps.

        `exchange` is the optional halo hook forwarded to face_states; the
        distributed executor (dist/shard.py) passes it so multi-chip runs
        the exact single-chip pipeline."""
        nb = mesh.n_bfaces
        phy = self.phy

        uL, uR, ug_cell, grads = self.face_states(mesh, u, exchange=exchange)

        flux = self._inviscid_face_flux(uL, uR, mesh.f_normal)   # (NF,4)

        if self.pcfg.viscous:
            # cell-centred states adjacent to each face; boundary right side
            # uses the ghost cell state and the left cell's gradient
            # (flow_spatial.cpp:529-541)
            ucl = u[mesh.f_left]
            ucr = u[mesh.f_right].at[:nb].set(ug_cell)
            gl = grads[mesh.f_left]
            gr_ = grads[mesh.f_right]
            gr_ = gr_.at[:nb].set(gl[:nb])

            wtl, wtr, gtl, gtr = prim2_states_and_gradients(
                phy, ucl, ucr, gl, gr_, self.ncfg.order2)
            fgrad = modified_average_gradient(
                mesh.f_dr_unit, mesh.f_dist, wtl, wtr, gtl, gtr)
            flux = flux + viscous_face_flux(phy, mesh.f_normal, fgrad,
                                            uL, uR, self.pcfg.const_visc)

        fluxlen = flux * mesh.f_len[:, None]                     # (NF,4)

        if not gettimesteps:
            g = fluxlen[mesh.cell_faces]                         # (NC,4,4)
            rhs = -(mesh.cell_fsign[..., None] * g).sum(axis=1)
            return rhs * mesh.cell_mask[:, None], None

        # pack flux + the two per-side spectral radii into ONE face payload
        # so the per-cell incidence gather happens once
        si, sj = self._face_spectral_radii(mesh, uL, uR)
        payload = jnp.concatenate(
            [fluxlen, si[:, None], sj[:, None]], axis=1)         # (NF,6)
        g = payload[mesh.cell_faces]                             # (NC,4,6)
        s = mesh.cell_fsign[..., None]
        rhs = -(s * g[..., :4]).sum(axis=1) * mesh.cell_mask[:, None]
        sel = jnp.where(mesh.cell_fsign > 0, g[..., 4],
                        jnp.where(mesh.cell_fsign < 0, g[..., 5], 0.0))
        integ = sel.sum(axis=1)
        dt = mesh.area / jnp.maximum(integ, 1e-300)
        return rhs, dt

    def assemble_jacobian(self, mesh, u):
        """First-order face-block Jacobian via jax.jacfwd (defect-correction
        quasi-Newton operator; aspatial.cpp:242-340)."""
        from ..solver.jacobian import assemble_jacobian
        return assemble_jacobian(self, mesh, u)

    def _face_spectral_radii(self, mesh, uL, uR):
        """Per-face convective (+viscous) spectral radii integrals
        (flow_spatial.cpp:566-634)."""
        phy = self.phy
        n = mesh.f_normal
        ci = phy.sound_speed_u(uL)
        cj = phy.sound_speed_u(uR)
        vni = (uL[:, 1] * n[:, 0] + uL[:, 2] * n[:, 1]) / uL[:, 0]
        vnj = (uR[:, 1] * n[:, 0] + uR[:, 2] * n[:, 1]) / uR[:, 0]
        si = (jnp.abs(vni) + ci) * mesh.f_len
        sj = (jnp.abs(vnj) + cj) * mesh.f_len

        if self.pcfg.viscous:
            if self.pcfg.const_visc:
                mui = muj = jnp.full_like(si, phy.const_viscosity)
            else:
                mui = phy.viscosity(uL)
                muj = phy.viscosity(uR)
            coi = jnp.maximum(4.0 / (3.0 * uL[:, 0]), phy.g / uL[:, 0])
            coj = jnp.maximum(4.0 / (3.0 * uR[:, 0]), phy.g / uR[:, 0])
            al = mesh.area[mesh.f_left]
            ar = mesh.area[mesh.f_right]
            si = si + coi * mui / phy.Pr * mesh.f_len ** 2 / al
            sj = sj + coj * muj / phy.Pr * mesh.f_len ** 2 / ar
        return si, sj

    def compute_timesteps(self, mesh, uL, uR):
        """Local pseudo-time steps dt_c = area_c / sum_f (|vn|+c+lambda_v)*len
        (flow_spatial.cpp:566-634)."""
        si, sj = self._face_spectral_radii(mesh, uL, uR)
        gi = si[mesh.cell_faces]                                 # (NC,4)
        gj = sj[mesh.cell_faces]
        sel = jnp.where(mesh.cell_fsign > 0, gi,
                        jnp.where(mesh.cell_fsign < 0, gj, 0.0))
        integ = sel.sum(axis=1)
        return mesh.area / jnp.maximum(integ, 1e-300)
