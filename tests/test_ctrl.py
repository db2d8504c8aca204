"""Control-file parser golden test.

Mirrors the reference's testparse (tests/utils/testparse.cpp, which asserts
the parsed FlowParserOptions of tests/utils/inv-explicit.ctrl field by field
against tests/utils/inv-explicit.testdata).
"""

from fvens_tpu.io_config import parse_control_file


def test_ctrl_parse_golden(refdir):
    cfg = parse_control_file(str(refdir / "tests/utils/inv-explicit.ctrl"))

    # io (inv-explicit.testdata lines 1-4)
    assert cfg.mesh_file.endswith("testcases/2dcylinder/grids/2dcylquad2.msh")

    # flow conditions (EULER / 1.4 / alpha 2.0 / Minf 0.38)
    assert not cfg.physics.viscous
    assert cfg.physics.gamma == 1.4
    assert cfg.physics.aoa_deg == 2.0
    assert cfg.physics.Minf == 0.38

    # bcs: slipwall marker 2, farfield marker 4; output walls (2,)
    bymarker = {b.marker: b.type for b in cfg.bcs}
    assert bymarker == {2: "slipwall", 4: "farfield"}
    assert cfg.wall_markers == (2,)

    # time + spatial (STEADY / LLF / LEASTSQUARES / NONE)
    assert cfg.numerics.flux == "LLF"
    assert cfg.numerics.gradient == "LEASTSQUARES"
    assert cfg.numerics.reconstruction == "LINEAR"   # limiter 'none'
    assert cfg.numerics.order2

    # pseudotime (EXPLICIT / 0.2 0.2 1e-5 500000 / 0.5 0.5 1e-1 5000)
    assert cfg.main.stepping == "explicit"
    assert cfg.main.cfl_init == 0.2 and cfg.main.cfl_fin == 0.2
    assert cfg.main.tol == 1e-5 and cfg.main.maxiter == 500000
    assert cfg.init.cfl_init == 0.5 and cfg.init.cfl_fin == 0.5
    assert cfg.init.tol == 1e-1 and cfg.init.maxiter == 5000


def test_ctrl_parse_viscous_fields(refdir):
    """The viscous north-star ctrl: NS physics + Roe + implicit ramp
    (testcases/visc-naca0012/laminar-implicit.ctrl)."""
    cfg = parse_control_file(
        str(refdir / "testcases/visc-naca0012/laminar-implicit.ctrl"))
    assert cfg.physics.viscous
    assert cfg.physics.Minf == 0.5
    assert cfg.physics.Reinf == 5000.0
    assert cfg.physics.Tinf == 288.15
    assert cfg.numerics.flux == "ROE"
    assert cfg.main.stepping == "implicit"
    assert cfg.main.cfl_init == 500.0 and cfg.main.cfl_fin == 5000.0
    bytype = {b.type for b in cfg.bcs}
    assert "adiabaticwall" in bytype


def test_solverc_parse_reference_files(refdir):
    """Every reference case's .solverc parses and maps onto this solver's
    linear solver config (FVENS doc/user-doc.md:17-25; -options_file)."""
    from fvens_tpu.io_config.solverc import load_solver_options

    # the default / visc-naca file: FGMRES(30) rtol 1e-1, bjacobi+ILU0
    lin, reorder, _ = load_solver_options(
        str(refdir / "testcases/visc-naca0012/opts.solverc"))
    assert lin.rtol == 0.1 and not lin.rtol_adapt
    assert lin.maxiter == 30 and lin.restart == 30
    assert lin.pc == "bsgs" and lin.pc_sweeps == 6   # ILU0-strength class
    assert reorder == "rcm"

    # 2dcylinder: SOR sub-PC -> multicolor SGS, max_it 20
    lin, reorder, _ = load_solver_options(
        str(refdir / "testcases/2dcylinder/opts.solverc"))
    assert lin.maxiter == 20 and lin.pc == "bcsgs"
    assert reorder == ""

    # the GAMG multigrid file -> aggregation AMG with matching depth/sweeps
    lin, _, _ = load_solver_options(
        str(refdir / "testcases/visc-naca0012/mgopts.solverc"))
    assert lin.pc == "amg"
    assert lin.mg_levels == 2          # PETSc counts 3 levels incl. fine
    assert lin.mg_nu1 == 2 and lin.mg_nu2 == 2
    assert lin.mg_coarse_sweeps == 6
    assert lin.maxiter == 10

    # BLASTed-as-shell (benchmark.solverc): ilu0 via -sub_pc_type shell
    lin, _, _ = load_solver_options(
        str(refdir / "testcases/visc-naca0012/benchmark.solverc"))
    assert lin.pc == "bsgs" and lin.maxiter == 70


def test_solverc_matrix_free_mapping(refdir, tmp_path):
    """-matrix_free_jacobian / -matrix_free_difference_step map onto
    LinearSolverConfig.matrix_free/matrix_free_fd/fd_eps (the reference's
    FD Jacobian shell, alinalg.cpp:124-233; shipped in
    tests/solvers/matfree.solverc)."""
    from fvens_tpu.io_config.solverc import (load_solver_options,
                                             parse_solverc,
                                             apply_solver_options)

    # the shipped reference file enables matrix-free when uncommented;
    # write the uncommented form verbatim
    src = parse_solverc(str(refdir / "tests/solvers/matfree.solverc"))
    assert "matrix_free_jacobian" not in src     # commented out upstream
    p = tmp_path / "mf.solverc"
    p.write_text("-matrix_free_jacobian\n"
                 "-matrix_free_difference_step 1e-6\n"
                 "-ksp_type fgmres\n-ksp_rtol 1e-1\n-ksp_max_it 30\n"
                 "-pc_type bjacobi\n-sub_pc_type ilu\n"
                 "-sub_pc_factor_levels 1\n-mesh_reorder rcm\n")
    msgs = []
    lin, reorder, _ = load_solver_options(str(p), warn=msgs.append)
    assert lin.matrix_free and lin.matrix_free_fd
    assert lin.fd_eps == 1e-6
    assert lin.rtol == 0.1 and lin.maxiter == 30
    assert reorder == "rcm"
    assert not msgs                       # nothing warned as ignored

    # anisotropy threshold comes back for the line orderings
    p2 = tmp_path / "an.solverc"
    p2.write_text("-mesh_reorder line_rcm\n-mesh_anisotropy_threshold 25\n")
    _, reorder, aniso = load_solver_options(str(p2))
    assert reorder == "line_rcm" and aniso == 25.0


def test_solverc_unknown_options_warn(tmp_path):
    from fvens_tpu.io_config.solverc import load_solver_options
    p = tmp_path / "o.solverc"
    p.write_text("-ksp_rtol 1e-2\n-totally_unknown_thing 3\n"
                 "# comment\n-options_left\n")
    msgs = []
    lin, _, _ = load_solver_options(str(p), warn=msgs.append)
    assert lin.rtol == 1e-2
    assert any("totally_unknown_thing" in m for m in msgs)
    assert not any("options_left" in m for m in msgs)


def test_linear_cfl_ramp():
    """SteadySolver::linearRamp parity (aodesolver.cpp:88-108)."""
    from fvens_tpu.solver.steady import linear_ramp
    assert linear_ramp(10.0, 100.0, 5, 15, 0) == 10.0
    assert linear_ramp(10.0, 100.0, 5, 15, 5) == 10.0
    assert linear_ramp(10.0, 100.0, 5, 15, 10) == 55.0
    assert linear_ramp(10.0, 100.0, 5, 15, 15) == 100.0
    assert linear_ramp(10.0, 100.0, 5, 15, 99) == 100.0
    assert linear_ramp(10.0, 100.0, 5, 5, 4) == 10.0
    assert linear_ramp(10.0, 100.0, 5, 5, 5) == 100.0
