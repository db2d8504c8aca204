"""chip_smoke.py's contract off the card, and the case files it writes."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_device_phase_fails_without_gpu():
    """On a CPU-only process the device phase fails, the script exits
    non-zero and never prints the ok line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_result_line_keys():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")] * 4
    line = chip_smoke.result_line(devs)
    rec = json.loads(line)
    assert list(rec) == ["ok", "device"]
    assert rec["ok"] is True
    assert rec["device"] == {"platform": "gpu", "kind": "NVIDIA H100",
                             "count": 4}
    assert "\n" not in line


def test_naca_case_files(tmp_path):
    """The generated control and options files carry the flagship physics
    and map onto matrix-free Newton with bsgs x6 through the CLI's own
    readers."""
    from fvens_tpu.cases.flagship import write_naca_laminar
    from fvens_tpu.io_config import parse_control_file
    from fvens_tpu.io_config.solverc import load_solver_options
    from fvens_tpu.mesh.reader import read_mesh

    ctrl, solverc = write_naca_laminar(str(tmp_path), nt=32, nr=12,
                                       tol=1e-7, maxiter=123)
    cfg = parse_control_file(ctrl)
    assert cfg.physics.viscous and cfg.physics.Minf == 0.5
    assert cfg.physics.Reinf == 5000.0
    assert (cfg.numerics.flux, cfg.numerics.gradient) == ("ROE",
                                                          "LEASTSQUARES")
    assert {(b.marker, b.type) for b in cfg.bcs} == {
        (2, "adiabaticwall"), (4, "inflowoutflow")}
    assert cfg.wall_markers == (2,)
    assert (cfg.main.cfl_init, cfg.main.cfl_fin) == (500.0, 5000.0)
    assert (cfg.main.tol, cfg.main.maxiter) == (1e-7, 123)
    assert (cfg.init.cfl_init, cfg.init.cfl_fin, cfg.init.maxiter) == (
        200.0, 1000.0, 50)
    assert cfg.use_starter and cfg.init.tol == 1e-1
    assert read_mesh(cfg.mesh_file).nelem == 32 * 12
    lin, _, _ = load_solver_options(solverc, base=cfg.linear)
    assert (lin.pc, lin.pc_sweeps) == ("bsgs", 6)
    assert lin.matrix_free and lin.matrix_free_fd
