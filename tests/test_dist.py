"""Multi-chip domain decomposition tests on the virtual 8-device CPU mesh.

Equivalent role to the reference MPI tests (partition restriction sanity,
trace-vector halo exchange, distributed solves — tests/mesh/distributedmesh,
tests/solvers/testtracevector): the sharded residual must match the
single-device residual cell for cell, and a sharded explicit solve must
track the single-device one.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fvens_tpu.config import BCSpec, NumericsConfig, PhysicsConfig
from fvens_tpu.dist import ShardedFlow, partition_mesh
from fvens_tpu.fv.residual import FlowFV
from fvens_tpu.mesh import compile_mesh
from fvens_tpu.mesh.meshgen import cylinder_omesh
from fvens_tpu.mesh.topology import build_topology
from fvens_tpu.physics import GasPhysics


def make_space(order2=True, viscous=False, recon="LINEAR"):
    pcfg = PhysicsConfig(Minf=0.38, viscous=viscous,
                         Reinf=100.0 if viscous else 1.0)
    ncfg = NumericsConfig(flux="HLLC", gradient="LEASTSQUARES",
                          reconstruction=recon, order2=order2)
    phy = GasPhysics(g=pcfg.gamma, Minf=pcfg.Minf, Tinf=pcfg.Tinf,
                     Reinf=pcfg.Reinf, Pr=pcfg.Pr)
    return FlowFV(phy=phy, pcfg=pcfg, ncfg=ncfg)


BCS = [BCSpec(marker=2, type="slipwall"), BCSpec(marker=4, type="farfield")]


@pytest.mark.parametrize("order2,recon,viscous", [
    (False, "LINEAR", False),
    (True, "LINEAR", False),
    (True, "WENO", False),      # WENO reads neighbour gradients: exercises
                                # the limited-gradient halo round
    (True, "VENKATAKRISHNAN", False),   # cell limiter, same extra round
    (True, "VANALBADA", False),         # face-based MUSCL path
    (True, "LINEAR", True),     # viscous fluxes read face gradients
])
def test_sharded_residual_matches_single_device(order2, recon, viscous):
    ndev = len(jax.devices())
    assert ndev >= 2, "test needs the 8-device CPU mesh from conftest"

    md = cylinder_omesh(32, 12)
    space = make_space(order2=order2, viscous=viscous, recon=recon)

    # single-device reference
    cm = compile_mesh(md, BCS)
    # a smooth non-uniform state: freestream + positional perturbation
    rc = np.asarray(cm.rc)
    pert = 0.05 * np.sin(rc[:, 0]) * np.cos(rc[:, 1])
    u_single = jnp.asarray(
        np.tile(np.asarray(space.uinf), (cm.NC, 1))
        * (1.0 + pert[:, None] * np.array([1.0, 0.5, -0.5, 1.0])))
    rhs_single, dt_single = space.compute_residual(cm, u_single, True)

    # sharded
    bundle = partition_mesh(md, BCS, ndev)
    sf = ShardedFlow(space=space, bundle=bundle, devices=jax.devices())

    # scatter the same state into the local layout
    gid = np.asarray(bundle.own_gid)
    u_np = np.asarray(u_single)
    u_loc = np.tile(np.asarray(space.uinf), (ndev, bundle.mesh.NC, 1))
    for p in range(ndev):
        n_own = int(bundle.own_counts[p])
        u_loc[p, :n_own] = u_np[gid[p, :n_own]]
    u_sh = jnp.asarray(u_loc)

    rhs_sh, dt_sh = jax.jit(sf.residual)(u_sh)
    rhs_g = sf.gather_solution(rhs_sh)
    dt_g = sf.gather_solution(np.asarray(dt_sh)[..., None])[:, 0]

    np.testing.assert_allclose(rhs_g, np.asarray(rhs_single)[: cm.n_cells],
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dt_g, np.asarray(dt_single)[: cm.n_cells],
                               rtol=1e-10, atol=1e-14)


def test_ppermute_halo_matches_allgather():
    """The scheduled neighbour-ppermute exchange must fill exactly the same
    halo slots with the same values as the all_gather reference path, and
    its per-round traffic must be bounded by the partition boundary (not D)."""
    from jax.sharding import PartitionSpec as P

    from fvens_tpu.dist.shard import (AXIS, halo_exchange,
                                      halo_exchange_allgather)

    ndev = len(jax.devices())
    md = cylinder_omesh(32, 12)
    bundle = partition_mesh(md, BCS, ndev)
    b = bundle

    # a field that distinguishes every (part, cell) pair
    rng = np.random.default_rng(7)
    field = jnp.asarray(rng.normal(size=(ndev, b.mesh.NC, 4)))

    def via_pp(mesh_unused, pps, ppr, f):
        return halo_exchange((pps[0], ppr[0], b.pp_perms), f[0])[None]

    def via_ag(si, hs, hsrc, f):
        return halo_exchange_allgather((si[0], hs[0], hsrc[0]), f[0])[None]

    sf = ShardedFlow(space=make_space(), bundle=b, devices=jax.devices())
    out_pp = jax.jit(jax.shard_map(
        via_pp, mesh=sf.jmesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P(AXIS)))(b.mesh.area, b.pp_send, b.pp_recv, field)
    out_ag = jax.jit(jax.shard_map(
        via_ag, mesh=sf.jmesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P(AXIS)))(b.send_idx, b.halo_slots, b.halo_src, field)
    np.testing.assert_array_equal(np.asarray(out_pp), np.asarray(out_ag))

    # schedule sanity: rounds bounded by neighbour degree, traffic by the
    # largest single-neighbour boundary strip
    assert len(b.pp_perms) <= ndev  # far below D*max_send total traffic
    assert b.pp_send.shape[-1] <= b.max_send


def test_partition_covers_all_cells():
    md = cylinder_omesh(24, 10)
    topo = build_topology(md)
    from fvens_tpu.dist.partition import greedy_partition
    part = greedy_partition(topo.esuel, np.asarray(topo.nfael), 4)
    assert part.min() >= 0 and part.max() == 3
    counts = np.bincount(part)
    assert counts.sum() == md.nelem
    assert counts.max() <= 2 * counts.min() + 8  # roughly balanced


def test_partition_refinement_cuts_edges():
    """KL/FM boundary refinement (the Scotch-quality role,
    meshpartitioning.cpp:432-461): on an unstructured mesh the refined BFS
    partition's edge cut must beat the trivial contiguous split and never
    exceed the raw BFS cut, at bounded imbalance. The triangulated
    cylinder's cells are shuffled by a seeded permutation, so contiguous
    index blocks are a poor partition, as on a real unordered mesh."""
    from fvens_tpu.dist.partition import (edge_cut, greedy_partition,
                                          refine_partition)
    from fvens_tpu.mesh.meshgen import cylinder_family
    from fvens_tpu.mesh.ordering import reorder_mesh

    md = cylinder_family(1, tri=True)[0]
    md = reorder_mesh(md, np.random.default_rng(0).permutation(md.nelem))
    topo = build_topology(md)
    nfael = np.asarray(topo.nfael)
    nparts = 3

    # the reference's trivial partitioner: contiguous index blocks
    # (meshpartitioning.cpp:354)
    trivial = np.minimum(np.arange(topo.nelem) * nparts // topo.nelem,
                         nparts - 1)
    bfs = greedy_partition(topo.esuel, nfael, nparts)
    ref_part = refine_partition(topo.esuel, nfael, bfs, nparts)

    cut_triv = edge_cut(topo.esuel, nfael, trivial)
    cut_bfs = edge_cut(topo.esuel, nfael, bfs)
    cut_ref = edge_cut(topo.esuel, nfael, ref_part)
    assert cut_ref <= cut_bfs
    assert cut_ref <= cut_triv
    counts = np.bincount(ref_part, minlength=nparts)
    assert counts.sum() == topo.nelem
    assert counts.min() >= int(np.floor(topo.nelem / nparts / 1.1))


def test_sharded_fe_step_matches_single_device():
    """One explicit forward-Euler step, distributed vs single-device
    (the full update path: residual + halo + local dt + psum norm)."""
    ndev = len(jax.devices())
    md = cylinder_omesh(32, 12)
    space = make_space(order2=True)

    cm = compile_mesh(md, BCS)
    from fvens_tpu.solver.steady import SteadyForwardEuler, residual_norm
    from fvens_tpu.config import PseudoTimeConfig
    fe = SteadyForwardEuler(space, PseudoTimeConfig(cfl_init=0.5))
    u0 = jnp.tile(space.uinf, (cm.NC, 1))
    u1, res1 = fe._step(cm, u0)

    bundle = partition_mesh(md, BCS, ndev)
    sf = ShardedFlow(space=space, bundle=bundle, devices=jax.devices())
    us = sf.initial_state()
    step = sf.fe_step_fn(cfl=0.5)
    us1, res_sh = step(us)

    u1g = sf.gather_solution(np.asarray(us1))
    np.testing.assert_allclose(u1g, np.asarray(u1)[: cm.n_cells],
                               rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(float(res_sh), float(res1), rtol=1e-11)


def test_sharded_implicit_step_matches_single_device():
    """One distributed backward-Euler step vs single-device, with identical
    linear settings (shard-local SGS differs from global SGS, so compare
    with block-Jacobi preconditioning where both are identical up to the
    Krylov trajectory, and use a tight linear tolerance so du converges)."""
    ndev = len(jax.devices())
    md = cylinder_omesh(32, 12)
    space = make_space(order2=True)
    from fvens_tpu.config import (LinearSolverConfig, NonlinearUpdateConfig,
                                  PseudoTimeConfig)
    from fvens_tpu.solver.steady import SteadyBackwardEuler

    lin = LinearSolverConfig(restart=80, maxiter=80, rtol=1e-10,
                             rtol_adapt=False, pc="bjacobi")
    nl = NonlinearUpdateConfig(scheme="full")

    cm = compile_mesh(md, BCS)
    be = SteadyBackwardEuler(space, PseudoTimeConfig(), lin, nl)
    u0 = jnp.tile(space.uinf, (cm.NC, 1))
    u1, res1, it1 = be._step(cm, u0, jnp.asarray(50.0), jnp.asarray(1e-10))

    bundle = partition_mesh(md, BCS, ndev)
    sf = ShardedFlow(space=space, bundle=bundle, devices=jax.devices())
    us = sf.initial_state()
    step = sf.be_step_fn(lin=lin, nl=nl)
    us1, res_sh, it_sh = step(us, 50.0, 1e-10)

    np.testing.assert_allclose(float(res_sh), float(res1), rtol=1e-10)
    u1g = sf.gather_solution(np.asarray(us1))
    np.testing.assert_allclose(u1g, np.asarray(u1)[: cm.n_cells],
                               rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("fd", [False, True])
def test_sharded_matrixfree_step_matches_single_device(fd):
    """One distributed MATRIX-FREE backward-Euler step vs the single-chip
    matrix-free step (exact-JVP and the reference's eps/||x|| FD shell):
    with block-Jacobi pc and a tight linear tolerance both converge to the
    same Newton direction. The reference runs testmatrixfree under MPIEXEC
    (tests/CMakeLists.txt)."""
    ndev = len(jax.devices())
    md = cylinder_omesh(32, 12)
    space = make_space(order2=True)
    from fvens_tpu.config import (LinearSolverConfig, NonlinearUpdateConfig,
                                  PseudoTimeConfig)
    from fvens_tpu.solver.steady import SteadyBackwardEuler
    from fvens_tpu.dist.shard import DistributedBackwardEuler

    lin = LinearSolverConfig(restart=80, maxiter=80, rtol=1e-10,
                             rtol_adapt=False, pc="bjacobi",
                             matrix_free=True, matrix_free_fd=fd)
    nl = NonlinearUpdateConfig(scheme="full")

    cm = compile_mesh(md, BCS)
    be = SteadyBackwardEuler(space, PseudoTimeConfig(), lin, nl)
    u0 = jnp.tile(space.uinf, (cm.NC, 1))
    u1, res1, it1 = be._step(cm, u0, jnp.asarray(50.0), jnp.asarray(1e-10))

    bundle = partition_mesh(md, BCS, ndev)
    sf = ShardedFlow(space=space, bundle=bundle, devices=jax.devices())
    dbe = DistributedBackwardEuler(space=space, cfg=PseudoTimeConfig(),
                                   lin=lin, nl=nl, flow=sf)
    us1, res_sh, it_sh = jax.jit(dbe._step)(
        sf.dist_mesh(), sf.initial_state(), 50.0, 1e-10)

    np.testing.assert_allclose(float(res_sh), float(res1), rtol=1e-10)
    u1g = sf.gather_solution(np.asarray(us1))
    # FD matvecs perturb by a global-norm-scaled step, so the distributed
    # Krylov trajectory is close but not bitwise; JVP is tighter
    tol = 1e-6 if fd else 1e-7
    np.testing.assert_allclose(u1g, np.asarray(u1)[: cm.n_cells],
                               rtol=tol, atol=10 * tol * 1e-2)


def test_banded_structure_parts_covers_all_slots():
    """Per-part band analysis (banded_structure_parts): bands + rest lists
    must cover every valid neighbour slot of every shard exactly once, with
    ONE static offsets tuple shared across shards (SPMD)."""
    from fvens_tpu.solver.banded import banded_structure_parts
    ndev = len(jax.devices())
    md = cylinder_omesh(32, 12)
    bundle = partition_mesh(md, BCS, ndev)
    m = bundle.mesh
    nb = np.asarray(m.cell_nbrs)
    mask = np.asarray(m.nbr_mask) > 0
    bl = banded_structure_parts(nb, mask)
    assert bl is not None, "structured O-mesh parts must be band-dominant"
    covered = int(np.asarray(bl.valid).sum())
    rest = int(np.asarray(bl.rest_valid).sum())
    assert covered + rest == int(mask.sum())
    # seam cells exist on every part, so the rest lists must be non-empty
    # but small relative to the interior bands
    assert 0 < rest < covered


def test_sharded_banded_step_matches_gather():
    """One distributed implicit step with the banded (shifted-slice)
    encoding vs the distributed gather step: same partitioning, same
    shard-local bsgs pc, tight linear tolerance — the banded operators
    differ only in neighbour summation order, so the converged Newton
    directions must agree."""
    ndev = len(jax.devices())
    md = cylinder_omesh(32, 12)
    space = make_space(order2=True)
    from fvens_tpu.config import (LinearSolverConfig, NonlinearUpdateConfig,
                                  PseudoTimeConfig)
    from fvens_tpu.dist.shard import DistributedBackwardEuler

    bundle = partition_mesh(md, BCS, ndev)
    nl = NonlinearUpdateConfig(scheme="full")
    outs = {}
    for banded in (False, True):
        lin = LinearSolverConfig(restart=80, maxiter=80, rtol=1e-10,
                                 rtol_adapt=False, pc="bsgs", pc_sweeps=4,
                                 banded=banded)
        sf = ShardedFlow(space=space, bundle=bundle, devices=jax.devices())
        dbe = DistributedBackwardEuler(space=space, cfg=PseudoTimeConfig(),
                                       lin=lin, nl=nl, flow=sf)
        dmesh = sf.dist_mesh()
        bl = dbe._banded(dmesh)
        assert (bl is not None) == banded
        us1, res, it = jax.jit(dbe._step)(
            dmesh, sf.initial_state(), 50.0, 1e-10, bl=bl)
        outs[banded] = (sf.gather_solution(np.asarray(us1)), float(res))
    np.testing.assert_allclose(outs[True][1], outs[False][1], rtol=1e-12)
    np.testing.assert_allclose(outs[True][0], outs[False][0],
                               rtol=1e-7, atol=1e-10)


def test_sharded_warmstart_plumbing_matches_cold():
    """Distributed warm start (lin.warm_start): a zero initial direction
    must reproduce the cold step (x0 = 0 either way; only XLA program-level
    re-association separates the two jitted programs, so the match is to
    ~machine epsilon rather than bitwise), and the returned direction must
    be finite — the controller-level carry is the single-chip code path,
    inherited."""
    ndev = len(jax.devices())
    md = cylinder_omesh(24, 10)
    space = make_space(order2=False)
    from fvens_tpu.config import (LinearSolverConfig, NonlinearUpdateConfig,
                                  PseudoTimeConfig)
    from fvens_tpu.dist.shard import DistributedBackwardEuler

    bundle = partition_mesh(md, BCS, ndev)
    lin = LinearSolverConfig(restart=40, maxiter=40, rtol=1e-8,
                             rtol_adapt=False, pc="bjacobi", warm_start=True)
    sf = ShardedFlow(space=space, bundle=bundle, devices=jax.devices())
    dbe = DistributedBackwardEuler(
        space=space, cfg=PseudoTimeConfig(), lin=lin,
        nl=NonlinearUpdateConfig(scheme="full"), flow=sf)
    dmesh, us = sf.dist_mesh(), sf.initial_state()
    u_cold, res_cold, it_cold = jax.jit(dbe._step)(dmesh, us, 50.0, 1e-8)
    u_warm, res_warm, it_warm, du = jax.jit(
        partial(dbe._step, return_du=True))(
            dmesh, us, 50.0, 1e-8, du0=jnp.zeros_like(us))
    assert np.isfinite(np.asarray(du)).all()
    np.testing.assert_allclose(np.asarray(u_warm), np.asarray(u_cold),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(res_warm), float(res_cold), rtol=1e-12)
    assert int(it_warm) == int(it_cold)


def test_sharded_deflated_step_matches_and_recycles():
    """Distributed GCRO-DR (lin.deflation_k): the deflated step must reach
    the same Newton direction as the plain step at tight linear tolerance,
    harvest an orthonormal recycle space (psum'd Gram ~= I across shards),
    and accept that space back on the next call."""
    ndev = len(jax.devices())
    md = cylinder_omesh(24, 10)
    space = make_space(order2=False)
    from fvens_tpu.config import (LinearSolverConfig, NonlinearUpdateConfig,
                                  PseudoTimeConfig)
    from fvens_tpu.dist.shard import DistributedBackwardEuler

    bundle = partition_mesh(md, BCS, ndev)
    nl = NonlinearUpdateConfig(scheme="full")
    k = 6
    lin0 = LinearSolverConfig(restart=60, maxiter=60, rtol=1e-10,
                              rtol_adapt=False, pc="bjacobi")
    lin1 = LinearSolverConfig(restart=60, maxiter=60, rtol=1e-10,
                              rtol_adapt=False, pc="bjacobi", deflation_k=k)
    sf = ShardedFlow(space=space, bundle=bundle, devices=jax.devices())
    dmesh, us = sf.dist_mesh(), sf.initial_state()

    be0 = DistributedBackwardEuler(space=space, cfg=PseudoTimeConfig(),
                                   lin=lin0, nl=nl, flow=sf)
    u_ref, res_ref, _ = jax.jit(be0._step)(dmesh, us, 50.0, 1e-10)

    be1 = DistributedBackwardEuler(space=space, cfg=PseudoTimeConfig(),
                                   lin=lin1, nl=nl, flow=sf)
    step1 = jax.jit(partial(be1._step, return_defl=True))
    u1, res1, it1, U1 = step1(dmesh, us, 50.0, 1e-10)
    assert np.isfinite(np.asarray(U1)).all()
    # orthonormal across the sharded axis: sum_p U1[p] @ U1[p].T ~= I
    Un = np.asarray(U1).astype(np.float64)         # (D, k, NC, V)
    flat = Un.reshape(Un.shape[0], k, -1)
    gram = sum(flat[p] @ flat[p].T for p in range(Un.shape[0]))
    np.testing.assert_allclose(gram, np.eye(k), atol=1e-6)
    np.testing.assert_allclose(float(res1), float(res_ref), rtol=1e-12)
    np.testing.assert_allclose(sf.gather_solution(np.asarray(u1)),
                               sf.gather_solution(np.asarray(u_ref)),
                               rtol=1e-7, atol=1e-9)
    # recycle round trip: the harvested space feeds the next step
    u2, res2, it2, U2 = step1(dmesh, u1, 50.0, 1e-10, U0=U1)
    assert np.isfinite(np.asarray(u2)).all()
    assert np.isfinite(np.asarray(U2)).all()


@pytest.mark.slow
def test_distributed_matrixfree_same_step_count():
    """Distributed matrix-free vs distributed assembled-Jacobian solves must
    converge in the SAME number of pseudo-time steps — the reference's
    testmatrixfree.cpp gate (:62-66), run under MPI, here over the virtual
    8-device mesh."""
    ndev = len(jax.devices())
    md = cylinder_omesh(24, 10)
    space = make_space(order2=False)
    from fvens_tpu.config import (LinearSolverConfig, NonlinearUpdateConfig,
                                  PseudoTimeConfig)
    bundle = partition_mesh(md, BCS, ndev)
    pt = PseudoTimeConfig(cfl_init=50.0, cfl_fin=500.0, tol=1e-6,
                          maxiter=200)
    nl = NonlinearUpdateConfig(scheme="full")
    steps = {}
    for key, mf, fd in (("asm", False, False), ("jvp", True, False),
                        ("fd", True, True)):
        sf = ShardedFlow(space=space, bundle=bundle, devices=jax.devices())
        lin = LinearSolverConfig(restart=40, maxiter=40, rtol=1e-3,
                                 pc="bcsgs", pc_sweeps=1, matrix_free=mf,
                                 matrix_free_fd=fd)
        u, info = sf.solve_implicit(pt, lin=lin, nl=nl)
        assert info.converged
        steps[key] = info.steps
    assert steps["asm"] == steps["jvp"] == steps["fd"], (
        f"distributed step counts differ: {steps}")


@pytest.mark.slow
@pytest.mark.parametrize("pc", ["bcsgs", "ilu0"])
def test_distributed_implicit_solve_converges(pc):
    """Full distributed implicit solve on 8 virtual devices reaches the same
    entropy as the single-device solver. pc='ilu0' exercises the shard-local
    Schwarz-ILU0 — the reference's parallel bjacobi+ILU0 default layout."""
    ndev = len(jax.devices())
    md = cylinder_omesh(32, 12)
    space = make_space(order2=True)
    from fvens_tpu.config import (LinearSolverConfig, NonlinearUpdateConfig,
                                  PseudoTimeConfig)
    bundle = partition_mesh(md, BCS, ndev)
    sf = ShardedFlow(space=space, bundle=bundle, devices=jax.devices())
    u, info = sf.solve_implicit(
        PseudoTimeConfig(cfl_init=25.0, cfl_fin=500.0, tol=1e-5, maxiter=300),
        lin=LinearSolverConfig(restart=60, maxiter=60, rtol=1e-2,
                               rtol_adapt=False, pc=pc, pc_sweeps=3),
        nl=NonlinearUpdateConfig(scheme="robust_flow"))
    assert info.converged
    ug = sf.gather_solution(np.asarray(u))
    # entropy error vs single-device solve of the same case
    from fvens_tpu.solver.steady import SteadyBackwardEuler
    from fvens_tpu.config import PseudoTimeConfig as PT
    cm = compile_mesh(md, BCS)
    be = SteadyBackwardEuler(
        space, PT(cfl_init=25.0, cfl_fin=500.0, tol=1e-5, maxiter=300))
    us, inf2 = be.solve(cm, jnp.tile(space.uinf, (cm.NC, 1)))
    from fvens_tpu.output import entropy_error
    e1 = entropy_error(space, cm, jnp.asarray(
        np.concatenate([ug, np.tile(np.asarray(space.uinf),
                                    (cm.NC - cm.n_cells, 1))])))
    e2 = entropy_error(space, cm, us)
    assert abs(e1 - e2) < 1e-4 * max(abs(e2), 1e-10)


def test_partition_restriction_matches_reference_goldens():
    """Trivial-partition restriction vs the reference's committed goldens:
    per-rank element distributions + cross-partition connectivity faces
    (tests/common-input/testhybrid-distb_part{1,2,3}.dat) and the pre-split
    local meshes (testhybrid_part{1,2,3}.msh) — the role of
    tests/mesh/distributedmesh.cpp checkTrivial. The goldens use the
    TRIVIAL partitioner (contiguous index blocks), which is deterministic,
    so they validate our restriction machinery directly."""
    import os
    import re

    from fvens_tpu.mesh.reader import read_mesh

    refdir = "/root/reference/tests/common-input"
    if not os.path.isdir(refdir):
        pytest.skip("reference fixtures unavailable")

    md = read_mesh(os.path.join(refdir, "testhybrid.msh"))
    nparts = 3
    part = np.arange(md.nelem, dtype=np.int32) * nparts // md.nelem
    bcs = [BCSpec(marker=1, type="slipwall"),
           BCSpec(marker=2, type="farfield")]
    bundle = partition_mesh(md, bcs, nparts, part=part)

    # global-face cross-partition adjacency (for the ConnFaces check)
    from fvens_tpu.mesh.topology import build_topology
    topo = build_topology(md)
    fc = np.asarray(topo.f_cells)
    interior = fc[:, 1] >= 0
    pairs = fc[interior]

    own_gid = np.asarray(bundle.own_gid)
    for p in range(nparts):
        txt = open(os.path.join(
            refdir, f"testhybrid-distb_part{p + 1}.dat")).read()
        head, conntxt = re.split(r"#Conn[Ff]aces", txt)
        elems = [int(x) for x in head.split()[1:]]
        conn = np.array([int(x) for x in conntxt.split()],
                        dtype=np.int64).reshape(-1, 4)

        n_own = int(bundle.own_counts[p])
        own = own_gid[p][:n_own].tolist()
        # golden: per-rank global element lists, in order
        assert own == elems

        # golden: the pre-split mesh's cells match our own cells' geometry
        mdl = read_mesh(os.path.join(refdir,
                                     f"testhybrid_part{p + 1}.msh"))
        assert mdl.nelem == n_own
        cent_gold = np.array([
            mdl.coords[mdl.inpoel[i, : mdl.nnode[i]]].mean(axis=0)
            for i in range(mdl.nelem)])
        rc_loc = np.asarray(bundle.mesh.rc)[p][:n_own]
        np.testing.assert_allclose(rc_loc, cent_gold, rtol=1e-12,
                                   atol=1e-14)

        # golden: cross-partition faces as (own local, nbr rank, nbr global)
        want = {(int(r[0]), int(r[2]), int(r[3])) for r in conn}
        got = set()
        l_of = {g: i for i, g in enumerate(own)}
        for a, b in pairs:
            for s, o in ((a, b), (b, a)):
                if part[s] == p and part[o] != p:
                    got.add((l_of[int(s)], int(part[o]), int(o)))
        assert got == want


def test_halo_schedule_stats_consistency():
    """Comm-volume accounting (halo_schedule_stats): the edge-coloured
    ppermute schedule must deliver every halo cell exactly once per
    exchange, and the reported volume must be consistent with the
    partition's edge cut (each ghost cell is adjacent to >=1 cut face, so
    halo_cells <= 2 * cut_faces and cut_faces > 0 on any real split)."""
    from fvens_tpu.dist import halo_schedule_stats

    md = cylinder_omesh(32, 12)
    bundle = partition_mesh(md, BCS, 4)
    hs = halo_schedule_stats(bundle)   # asserts sends == halo internally

    assert hs["halo_cells"] > 0
    assert hs["cut_faces"] > 0
    assert hs["halo_cells"] <= 2 * hs["cut_faces"]
    assert hs["rounds"] >= 1
    assert hs["messages_per_exchange"] >= 4     # >= one send per device
    assert hs["bytes_per_exchange"] == hs["halo_cells"] * 4 * 4  # f32 x 4


def test_distributed_case_refuses_more_devices_than_visible():
    """Asking for more devices than the process sees is an error, not a
    silent cut down to what is there."""
    from fvens_tpu.cases.casesolvers import DistributedFlowCase
    from fvens_tpu.config import FlowCaseConfig

    n = len(jax.devices())
    case = DistributedFlowCase(FlowCaseConfig(bcs=BCS), n_devices=n + 1)
    with pytest.raises(ValueError, match=f"{n + 1} devices requested"):
        case.solve(cylinder_omesh(16, 6))
