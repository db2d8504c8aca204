"""Regenerate tests/data/naca_laminar_cpu.json: the CPU float64 run of the
naca_laminar case that chip_smoke.py holds the GPU run to (CL, CDp, CDsf
within 1e-6).

The case files come from fvens_tpu/cases/flagship.py (generated O-mesh,
control file, .solverc) with the settings stored in the JSON's "case"; the
solve goes through the CLI's main, as on the GPU.

Usage: JAX_PLATFORMS=cpu python scripts/naca_laminar_cpu_reference.py
"""

import json
import os
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

OUT = os.path.join(_ROOT, "tests", "data", "naca_laminar_cpu.json")


def main() -> int:
    import jax

    import chip_smoke
    from fvens_tpu.cases.flagship import NACA_CASE, write_naca_laminar

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory(dir=_ROOT) as d:
        ctrl, solverc = write_naca_laminar(d, **NACA_CASE)
        res = chip_smoke.run_cli([ctrl, "--options_file", solverc,
                                  "--log_every", "50"])
    dev = jax.devices()[0]
    rec = {"case": NACA_CASE,
           "CL": res["CL"], "CDp": res["CDp"], "CDsf": res["CDsf"],
           "steps": res["steps"], "lin_iters": res["lin_iters"],
           "platform": dev.platform, "dtype": "float64",
           "command": "JAX_PLATFORMS=cpu python "
                      "scripts/naca_laminar_cpu_reference.py"}
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
