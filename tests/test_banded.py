"""Banded (shifted-slice) neighbour-encoding tests (solver/banded.py).

The banded operators must be exactly equivalent (up to neighbour summation
order) to the slot-gather operators on band-coverable meshes, and the
structure build must refuse meshes that are not fully band-coverable so
the solver silently keeps the gather path (LinearSolverConfig.banded).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from fvens_tpu.config import (BCSpec, LinearSolverConfig,
                              NonlinearUpdateConfig, NumericsConfig,
                              PhysicsConfig, PseudoTimeConfig)
from fvens_tpu.fv.residual import FlowFV
from fvens_tpu.mesh import compile_mesh
from fvens_tpu.mesh.meshgen import cylinder_omesh
from fvens_tpu.physics import GasPhysics
from fvens_tpu.solver import jacobian as jacmod
from fvens_tpu.solver.banded import (banded_blocks, banded_dn_blocks,
                                     banded_structure, make_banded_bsgs,
                                     make_banded_matvec)
from fvens_tpu.solver.linear import (block_jacobi_inverse, bsr_matvec,
                                     make_preconditioner)
from fvens_tpu.solver.steady import SteadyBackwardEuler

BCS = [BCSpec(marker=2, type="slipwall"), BCSpec(marker=4, type="farfield")]


def _space(order2=True):
    pcfg = PhysicsConfig(Minf=0.38, viscous=False)
    ncfg = NumericsConfig(flux="HLLC", gradient="LEASTSQUARES",
                          reconstruction="LINEAR", order2=order2)
    phy = GasPhysics(g=pcfg.gamma, Minf=pcfg.Minf, Tinf=pcfg.Tinf,
                     Reinf=pcfg.Reinf, Pr=pcfg.Pr)
    return FlowFV(phy=phy, pcfg=pcfg, ncfg=ncfg)


def _case(ni=32, nj=12):
    md = cylinder_omesh(ni, nj)
    cm = compile_mesh(md, BCS, dtype=jnp.float64)
    space = _space()
    u = jnp.tile(space.uinf, (cm.NC, 1)).astype(jnp.float64)
    # a non-trivial state (freestream Jacobians are too symmetric to catch
    # slot mix-ups): perturb deterministically
    key = jax.random.PRNGKey(0)
    u = u * (1.0 + 0.01 * jax.random.normal(key, u.shape, u.dtype))
    jac = space.assemble_jacobian(cm, u)
    jac = jacmod.add_pseudotime_term(
        cm, jac, 50.0, space.compute_residual(cm, u, True)[1])
    return cm, jac


def test_structure_covers_omesh_exactly():
    cm, _ = _case()
    bl = banded_structure(cm)
    assert bl is not None
    # O-mesh: 4 interior offsets + 2 circumferential seam offsets
    assert len(bl.offsets) == 6
    nbv = np.asarray(cm.nbr_mask) > 0
    assert int(np.asarray(bl.valid).sum()) == int(nbv.sum())
    # each valid slot is claimed by exactly one band, and the claimed slot
    # really holds a neighbour at that offset
    nb = np.asarray(cm.cell_nbrs)
    for k, d in enumerate(bl.offsets):
        sel = np.asarray(bl.slot_sel[k])
        v = np.asarray(bl.valid[k]) > 0
        c = np.arange(cm.NC)
        assert (nb[c[v], sel[v]] - c[v] == d).all()


def test_structure_refuses_unstructured_mesh():
    """A genuinely unstructured mesh has a flat offset histogram — the
    build must return None so the solver keeps the gather path. A
    triangulated cylinder with its cells shuffled by a seeded permutation
    has no band structure left to find."""
    from fvens_tpu.mesh.meshgen import cylinder_family
    from fvens_tpu.mesh.ordering import reorder_mesh
    md = cylinder_family(1, tri=True)[0]
    md = reorder_mesh(md, np.random.default_rng(0).permutation(md.nelem))
    cm = compile_mesh(md, BCS, dtype=jnp.float64)
    assert banded_structure(cm) is None


def test_banded_matvec_matches_gather():
    cm, jac = _case()
    bl = banded_structure(cm)
    x = jax.random.normal(jax.random.PRNGKey(1), (cm.NC, 4), jnp.float64)
    y_ref = bsr_matvec(cm, jac, x)
    mv = make_banded_matvec(jac.D, banded_blocks(bl, jac.N), bl.offsets)
    np.testing.assert_allclose(np.asarray(mv(x)), np.asarray(y_ref),
                               rtol=1e-13, atol=1e-13)


def test_banded_bsgs_matches_gather():
    cm, jac = _case()
    bl = banded_structure(cm)
    v = jax.random.normal(jax.random.PRNGKey(2), (cm.NC, 4), jnp.float64)
    pc_ref = make_preconditioner(cm, jac, "bsgs", sweeps=4)
    Dinv = block_jacobi_inverse(jac.D)
    pc_b = make_banded_bsgs(Dinv, banded_dn_blocks(bl, Dinv, jac.N),
                            bl.offsets, 4)
    np.testing.assert_allclose(np.asarray(pc_b(v)), np.asarray(pc_ref(v)),
                               rtol=1e-12, atol=1e-12)


def test_banded_solve_matches_functionals():
    """Full implicit solves with and without the banded encoding must both
    converge and agree on the converged state (trajectories drift at
    rounding level because the neighbour summation order differs, but the
    steady state is the same)."""
    md = cylinder_omesh(32, 12)
    cm = compile_mesh(md, BCS, dtype=jnp.float64)
    space = _space()
    u0 = jnp.tile(space.uinf, (cm.NC, 1)).astype(jnp.float64)

    def solve(banded):
        lin = LinearSolverConfig(restart=40, maxiter=40, rtol=1e-2,
                                 pc="bsgs", pc_sweeps=4, banded=banded)
        pt = PseudoTimeConfig(cfl_init=50.0, cfl_fin=2000.0, tol=1e-8,
                              maxiter=200)
        be = SteadyBackwardEuler(space, pt, lin,
                                 NonlinearUpdateConfig("full"))
        return be.solve(cm, u0)

    u1, i1 = solve(False)
    u2, i2 = solve(True)
    assert i1.converged and i2.converged
    # same steady state to far below the stopping tolerance
    assert float(jnp.abs(u1 - u2).max()) < 1e-7
