"""Functional regression tests against the reference's committed values.

Mirrors FVENS's e_testflow regression (tests/flow_solve.cpp + golden files
testcases/*/regr-*.txt): run a full case on the reference's own mesh and
compare (CL, CDp, CDsf). The reference gates at 1e-8 against its own
binaries; across an independent implementation the discretization-identical
values agree to the nonlinear solve tolerance — we gate at 1e-6 per
BASELINE.md.
"""

import pytest

from fvens_tpu.io_config import parse_control_file
from fvens_tpu.cases import SteadyFlowCase
from fvens_tpu.cases.casesolvers import load_case_mesh


@pytest.mark.slow
def test_visc_naca0012_regression(refdir):
    """Laminar NACA0012, Roe + WLS, implicit (the BASELINE.md north star).
    Golden: testcases/visc-naca0012/regr-LeastSquares_Roe.txt."""
    cfg = parse_control_file(
        str(refdir / "testcases/visc-naca0012/laminar-implicit.ctrl"))
    mesh = load_case_mesh(
        cfg, str(refdir / "testcases/visc-naca0012/grids/"
                          "NACA0012_lam_hybrid_1.msh"))
    case = SteadyFlowCase(cfg)
    u, info, fnls = case.run_output(mesh)
    assert info.converged
    ref_CL = 3.1542315562868e-05
    ref_CDp = 0.0111665585911807
    ref_CDsf = -0.0164800118334553
    assert abs(fnls.CL - ref_CL) < 1e-6
    assert abs(fnls.CDp - ref_CDp) < 1e-6
    assert abs(fnls.CDsf - ref_CDsf) < 1e-6


@pytest.mark.slow
def test_visc_cylinder_regression(refdir):
    """Laminar viscous cylinder, HLLC + WLS.
    Golden: testcases/visc-cylinder/regr-LeastSquares_HLLC.txt."""
    ctrl = refdir / "testcases/visc-cylinder/laminar-implicit.ctrl"
    cfg = parse_control_file(str(ctrl))
    meshfile = refdir / "testcases/visc-cylinder/grids/2dcylinderhybrid2.msh"
    if not meshfile.exists():
        # the reference generates this mesh with Gmsh at build time; it is
        # not committed, so the regression can only run where it exists
        pytest.skip("visc-cylinder mesh not committed in reference")
    mesh = load_case_mesh(cfg, str(meshfile))
    case = SteadyFlowCase(cfg)
    u, info, fnls = case.run_output(mesh)
    ref = (-0.000342434319864377, 0.325149277107277, -0.166147285368233)
    assert abs(fnls.CL - ref[0]) < 1e-6
    assert abs(fnls.CDp - ref[1]) < 1e-6
    assert abs(fnls.CDsf - ref[2]) < 1e-6


@pytest.mark.slow
def test_transonic_naca0012_muscl_regression(refdir):
    """Transonic inviscid NACA0012 (M=0.8, alpha=1.25), HLLC + MUSCL-VanAlbada
    + WLS. Golden: testcases/naca0012/regr-MUSCL_LeastSquares_HLLC.txt.
    The shock-formation phase trips one controlled blowup-recovery
    (PseudoTimeConfig.blowup_relres trust region) before converging."""
    import dataclasses
    cfg = parse_control_file(
        str(refdir / "testcases/naca0012/transonic-sanity-test-muscl.ctrl"))
    cfg = dataclasses.replace(
        cfg, main=dataclasses.replace(cfg.main, maxiter=450))
    mesh = load_case_mesh(
        cfg, str(refdir / "testcases/naca0012/grids/naca0012luo.msh"))
    u, info, fnls = SteadyFlowCase(cfg).run_output(mesh)
    assert abs(fnls.CL - 0.154112792928976) < 1e-6
    assert abs(fnls.CDp - 0.0115814414408097) < 1e-6


@pytest.mark.slow
def test_transonic_naca0012_muscl_line_reorder_regression(refdir):
    """The same MUSCL transonic case solved on the line_rcm-reordered mesh
    must reproduce the natural-ordering functionals — the reference commits
    a separate golden for exactly this check
    (testcases/naca0012/regr-MUSCL_LS_HLLC_LineOrdering.txt:1)."""
    import dataclasses

    from fvens_tpu.mesh.ordering import apply_ordering
    from fvens_tpu.mesh.reader import read_mesh
    from fvens_tpu.mesh import compile_mesh

    cfg = parse_control_file(
        str(refdir / "testcases/naca0012/transonic-sanity-test-muscl.ctrl"))
    # the reordered trajectory's shock-tail decays slowly (~x0.8/25 steps
    # at CFL 5000); measured convergence at 786 steps, budget with margin
    cfg = dataclasses.replace(
        cfg, main=dataclasses.replace(cfg.main, maxiter=900))
    md = read_mesh(str(refdir / "testcases/naca0012/grids/naca0012luo.msh"))
    md = apply_ordering(md, "line_rcm")
    mesh = compile_mesh(md, cfg.bcs)
    u, info, fnls = SteadyFlowCase(cfg).run_output(mesh)
    # reference golden for the reordered run (same values to its own 1e-8)
    assert abs(fnls.CL - 0.15411279292898) < 1e-6
    assert abs(fnls.CDp - 0.0115814414408098) < 1e-6


@pytest.mark.slow
def test_distributed_visc_naca0012_regression(refdir):
    """The north-star viscous NACA case solved domain-decomposed over the
    8 virtual devices must reproduce the single-chip functionals.
    Role of the reference's mpirun regression runs
    (tests/inv-2dcyl/CMakeLists.txt:31-37)."""
    import jax

    from fvens_tpu.cases.casesolvers import DistributedFlowCase
    from fvens_tpu.mesh.reader import read_mesh
    assert len(jax.devices()) >= 2

    cfg = parse_control_file(
        str(refdir / "testcases/visc-naca0012/laminar-implicit.ctrl"))
    md = read_mesh(str(refdir / "testcases/visc-naca0012/grids/"
                                "NACA0012_lam_hybrid_1.msh"))
    u, info, fnls = DistributedFlowCase(cfg).run_output(md)
    assert info.converged
    ref_CL = 3.1542315562868e-05
    ref_CDp = 0.0111665585911807
    ref_CDsf = -0.0164800118334553
    assert abs(fnls.CL - ref_CL) < 1e-6
    assert abs(fnls.CDp - ref_CDp) < 1e-6
    assert abs(fnls.CDsf - ref_CDsf) < 1e-6


@pytest.mark.slow
def test_transonic_naca0012_weno_regression(refdir):
    """Transonic inviscid NACA0012 (M=0.8, alpha=1.25), HLLC + WENO + WLS.
    Golden: testcases/naca0012/regr-WENO_LeastSquares_HLLC.txt. Note the
    reference ran with its (uninitialized -> 0) WENO lambda; see the parity
    note in io_config/ctrl.py."""
    import dataclasses
    cfg = parse_control_file(
        str(refdir / "testcases/naca0012/transonic-sanity-test-weno.ctrl"))
    cfg = dataclasses.replace(
        cfg, main=dataclasses.replace(cfg.main, maxiter=300))
    mesh = load_case_mesh(
        cfg, str(refdir / "testcases/naca0012/grids/naca0012luo.msh"))
    u, info, fnls = SteadyFlowCase(cfg).run_output(mesh)
    assert abs(fnls.CL - 0.151870649085658) < 1e-6
    assert abs(fnls.CDp - 0.013085625502343) < 1e-6


@pytest.mark.slow
def test_matfree_case_cli_end_to_end(refdir, tmp_path):
    """The reference's matrix-free gate, end to end through the CLI with no
    hand overrides beyond the mesh path: tests/solvers/matfree.ctrl +
    matfree.solverc, once as shipped (assembled Jacobian) and once with the
    commented matrix-free lines enabled (exactly what testmatrixfree.cpp
    exercises under MPIEXEC, tests/solvers/CMakeLists.txt). First-order
    case (gradient_method none): the assembled Jacobian is exact, so the
    pseudo-time step counts must match — the reference's own equivalence
    criterion."""
    import json

    from fvens_tpu.cases.cli import main

    ctrl = refdir / "tests/solvers/matfree.ctrl"
    mesh = refdir / "testcases/2dcylinder/grids/2dcylinder0.msh"
    src = (refdir / "tests/solvers/matfree.solverc").read_text()
    mf = src.replace("#-matrix_free_jacobian", "-matrix_free_jacobian")
    mf = mf.replace("#-matrix_free_difference_step",
                    "-matrix_free_difference_step")
    assert mf != src
    steps = {}
    for name, text in (("assembled", src), ("matfree", mf)):
        p = tmp_path / f"{name}.solverc"
        p.write_text(text)
        hist = tmp_path / f"{name}.jsonl"
        rc = main([str(ctrl), "--platform", "cpu",
                   "--mesh_file", str(mesh),
                   "-options_file", str(p),
                   "--history", str(hist), "--log_every", "50"])
        assert rc == 0
        lines = [json.loads(ln) for ln in
                 hist.read_text().splitlines() if ln.strip()]
        assert lines[-1]["relres"] < 1e-8          # ctrl tolerance reached
        steps[name] = lines[-1]["step"]
    assert steps["matfree"] == steps["assembled"]
