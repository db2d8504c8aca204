"""Mixed-precision deep convergence and checkpoint/resume equivalence.

The BASELINE.md metric demands 1e-10 steady residuals; the mixed path runs
an f32 Jacobian/Krylov direction inside an f64 residual/update loop
(LinearSolverConfig.mixed_precision). These tests pin that mode's
correctness on a small laminar cylinder case, that its f32 products run at
full precision whatever the device's default, and the checkpoint/resume
path the CLI exposes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fvens_tpu.config import (BCSpec, LinearSolverConfig,
                              NonlinearUpdateConfig, NumericsConfig,
                              PhysicsConfig, PseudoTimeConfig)
from fvens_tpu.fv.residual import FlowFV
from fvens_tpu.mesh import compile_mesh
from fvens_tpu.mesh.meshgen import cylinder_omesh
from fvens_tpu.output import surface_data
from fvens_tpu.physics import GasPhysics
from fvens_tpu.solver.steady import SteadyBackwardEuler

BCS = [BCSpec(marker=2, type="adiabaticwall", values=(0.0,)),
       BCSpec(marker=4, type="farfield")]


def _viscous_space():
    pcfg = PhysicsConfig(Minf=0.3, Reinf=40.0, Tinf=288.15, viscous=True)
    ncfg = NumericsConfig(flux="ROE", gradient="LEASTSQUARES",
                          reconstruction="LINEAR", order2=True)
    phy = GasPhysics(g=pcfg.gamma, Minf=pcfg.Minf, Tinf=pcfg.Tinf,
                     Reinf=pcfg.Reinf, Pr=pcfg.Pr)
    return FlowFV(phy=phy, pcfg=pcfg, ncfg=ncfg)


def _solve(mesh, space, mixed: bool, tol: float = 1e-10,
           checkpoint_path=None, maxiter: int = 400,
           checkpoint_every: int = 50, pc: str = "bcsgs"):
    pt = PseudoTimeConfig(cfl_init=100.0, cfl_fin=5000.0, tol=tol,
                          maxiter=maxiter)
    lin = LinearSolverConfig(restart=40, maxiter=40, rtol=1e-2,
                             pc=pc, pc_sweeps=1, mixed_precision=mixed)
    solver = SteadyBackwardEuler(space, pt, lin,
                                 NonlinearUpdateConfig(scheme="full"),
                                 checkpoint_path=checkpoint_path,
                                 checkpoint_every=checkpoint_every)
    u0 = jnp.tile(space.uinf, (mesh.NC, 1)).astype(jnp.float64)
    return solver.solve(mesh, u0)


def test_mixed_precision_deep_convergence():
    """f32 direction / f64 residual reaches 1e-10 and reproduces the plain
    f64 functionals (the mode bench.py runs)."""
    md = cylinder_omesh(32, 14, stretch=1.2)
    mesh = compile_mesh(md, BCS, dtype=jnp.float64)
    space = _viscous_space()

    u64, info64 = _solve(mesh, space, mixed=False)
    umx, infomx = _solve(mesh, space, mixed=True)
    assert info64.converged and infomx.converged
    assert infomx.finalres / infomx.initres <= 1e-10

    _, (cl64, cdp64, cdsf64) = surface_data(space, mesh, u64, [2])
    _, (clmx, cdpmx, cdsfmx) = surface_data(space, mesh, umx, [2])
    # at 1e-10 residual the steady state is pinned far tighter than 1e-8
    assert abs(clmx - cl64) < 1e-8
    assert abs(cdpmx - cdp64) < 1e-8
    assert abs(cdsfmx - cdsf64) < 1e-8


def test_bline_mixed_precision_stays_f32():
    """pc='bline' under mixed precision: the line smoother's mask arrays are
    built in f64 on the host and must not promote the f32 Jacobian blocks
    back to f64. Pin both the dtype and the solution."""
    import jax

    from fvens_tpu.solver.jacobian import add_pseudotime_term
    from fvens_tpu.solver.linear import make_preconditioner
    from fvens_tpu.solver.lines import lines_from_mesh

    md = cylinder_omesh(32, 14, stretch=1.2)
    mesh = compile_mesh(md, BCS, dtype=jnp.float64)
    space = _viscous_space()
    lines = lines_from_mesh(mesh)

    u = jnp.tile(space.uinf, (mesh.NC, 1)).astype(jnp.float64)
    mesh32 = mesh.astype(jnp.float32)
    rhs, dt = space.compute_residual(mesh, u, True)
    jac = space.assemble_jacobian(mesh32, u.astype(jnp.float32))
    jac = add_pseudotime_term(mesh32, jac, jnp.float32(100.0),
                              dt.astype(jnp.float32))
    pc = make_preconditioner(mesh32, jac, "bline", 1, lines=lines)
    z = jax.jit(pc)(rhs.astype(jnp.float32))
    assert z.dtype == jnp.float32          # no silent f64 promotion
    assert bool(jnp.isfinite(z).all())

    # and a short mixed solve with bline makes normal progress (the deep
    # bline-vs-bcsgs functional comparison lives in the slow suite)
    u_b, info_b = _solve(mesh, space, mixed=True, tol=1e-6, pc="bline",
                         maxiter=200)
    assert info_b.converged


@pytest.mark.slow
def test_bline_mixed_matches_bcsgs_functionals():
    """Deep (1e-9) mixed-precision solves with the line smoother and the
    colored SGS must land on the same functionals."""
    md = cylinder_omesh(32, 14, stretch=1.2)
    mesh = compile_mesh(md, BCS, dtype=jnp.float64)
    space = _viscous_space()
    u_b, info_b = _solve(mesh, space, mixed=True, tol=1e-9, pc="bline")
    u_c, info_c = _solve(mesh, space, mixed=True, tol=1e-9, pc="bcsgs")
    assert info_b.converged and info_c.converged
    _, f_b = surface_data(space, mesh, u_b, [2])
    _, f_c = surface_data(space, mesh, u_c, [2])
    np.testing.assert_allclose(np.asarray(f_b), np.asarray(f_c), atol=1e-8)


def _dot_generals(jaxpr):
    """Every dot_general equation in a jaxpr, sub-jaxprs included (while,
    cond, scan, pjit and custom-rule bodies)."""
    def subs(v):
        if hasattr(v, "eqns"):
            yield v
        elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
            yield v.jaxpr
        elif isinstance(v, (tuple, list)):
            for x in v:
                yield from subs(x)

    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in subs(v):
                yield from _dot_generals(sub)


@pytest.mark.parametrize("pc,banded", [
    ("bsgs", False), ("bsgs", True), ("bcsgs", False), ("ilu0", False),
    ("bline", False), ("amg", False)])
def test_mixed_step_f32_products_are_highest(pc, banded):
    """On the GPU a float32 dot_general without a precision may run in
    TF32 (~3 digits). Every f32 product of the mixed-precision implicit
    step must carry precision HIGHEST on both operands."""
    import jax
    from jax.lax import Precision

    md = cylinder_omesh(24, 10, stretch=1.2)
    mesh = compile_mesh(md, BCS, dtype=jnp.float64)
    space = _viscous_space()
    lin = LinearSolverConfig(restart=10, maxiter=10, rtol=1e-2, pc=pc,
                             pc_sweeps=2, mixed_precision=True, banded=banded,
                             mg_levels=2)
    be = SteadyBackwardEuler(space, PseudoTimeConfig(), lin,
                             NonlinearUpdateConfig(scheme="full"))
    be._lines(mesh)
    kw = dict(mg=be._mg(mesh), ilu=be._ilu(mesh), bl=be._banded(mesh),
              lmesh=mesh.astype(jnp.float32))
    assert (kw["bl"] is not None) == banded
    u = jnp.tile(space.uinf, (mesh.NC, 1)).astype(jnp.float64)
    jaxpr = jax.make_jaxpr(
        lambda u: be._step(mesh, u, 100.0, 1e-2, **kw))(u).jaxpr
    f32 = [e for e in _dot_generals(jaxpr)
           if any(v.aval.dtype == jnp.float32 for v in e.invars)]
    assert f32, "the mixed step should contract in f32"
    for e in f32:
        assert e.params["precision"] == (Precision.HIGHEST,
                                         Precision.HIGHEST), e


@pytest.mark.parametrize("blocked", [False, True])
def test_gmres_f32_products_are_highest(blocked):
    """Both Gram-Schmidt paths of gmres (CGS2 and blocked MGS) and the
    deflated gmres_dr pin HIGHEST on their f32 basis products."""
    import jax
    from jax.lax import Precision

    from fvens_tpu.solver.linear import gmres, gmres_dr

    A = jnp.eye(16, dtype=jnp.float32) * 3.0 + 0.1
    b = jnp.ones((4, 4), jnp.float32)
    mv = lambda x: (A @ x.reshape(16)).reshape(4, 4)

    def run(b):
        x, _, _ = gmres(mv, b, jnp.zeros_like(b), lambda v: v, restart=5,
                        maxiter=5, blocked=blocked)
        xd = gmres_dr(mv, b, jnp.zeros_like(b), lambda v: v, U=None, k=2,
                      restart=5, maxiter=5)[0]
        return x, xd

    jaxpr = jax.make_jaxpr(run)(b).jaxpr
    ours = [e for e in _dot_generals(jaxpr)
            if e.params["precision"] is not None]
    assert len(ours) >= 4
    # the test's own operator (A @ x) is the only unpinned product
    unpinned = [e for e in _dot_generals(jaxpr)
                if e.params["precision"] is None
                and e.invars[0].aval.shape != (16, 16)]
    assert not unpinned, unpinned
    for e in ours:
        assert e.params["precision"] == (Precision.HIGHEST,
                                         Precision.HIGHEST)


def test_checkpoint_resume_equivalence(tmp_path):
    """A solve interrupted mid-way and resumed from its checkpoint must
    reach the same steady state as an uninterrupted solve."""
    from fvens_tpu.solver.steady import ToleranceError

    md = cylinder_omesh(24, 10, stretch=1.2)
    mesh = compile_mesh(md, BCS, dtype=jnp.float64)
    space = _viscous_space()

    u_full, info_full = _solve(mesh, space, mixed=False, tol=1e-9)

    ck = str(tmp_path / "ck.npz")
    # interrupted run: too few steps to converge, but writes checkpoints
    with pytest.raises(ToleranceError):
        _solve(mesh, space, mixed=False, tol=1e-9, checkpoint_path=ck,
               maxiter=8, checkpoint_every=4)
    import os
    assert os.path.exists(ck)

    u_res, info_res = _solve(mesh, space, mixed=False, tol=1e-9,
                             checkpoint_path=ck)
    assert info_res.converged
    # resume started from step 8, not scratch
    assert info_res.steps < info_full.steps + 8
    np.testing.assert_allclose(np.asarray(u_res)[: mesh.n_cells],
                               np.asarray(u_full)[: mesh.n_cells],
                               rtol=1e-6, atol=1e-10)
