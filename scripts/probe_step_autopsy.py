"""Time each per-step component of the implicit solver at large mesh
sizes, separately from the Krylov probe (scripts/probe_gmres_scaling.py).

Attributing a whole implicit step to the Krylov loop overstates the
per-iteration cost; this probe times the step's serial components on
device so the blame lands correctly:

  residual_f64     second-order residual + local dt in the state dtype
  assembly_f32     first-order Jacobian assembly at the f32 state
  banded_setup     block_jacobi_inverse + banded_(dn_)blocks reorders
  update_f64       positivity-line-searched state update (6 pressure
                   evaluations + axpy), f64

Usage: python scripts/probe_step_autopsy.py --sizes 640x320 1280x640
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", nargs="+", default=["640x320", "1280x640"])
    ap.add_argument("--platform", default=None)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)
    from fvens_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from scripts.bench_bigmesh import build_case
    from fvens_tpu.cases.casesolvers import build_space
    from fvens_tpu.solver import jacobian as jacmod
    from fvens_tpu.solver.banded import (banded_blocks, banded_dn_blocks,
                                         banded_structure)
    from fvens_tpu.solver.linear import block_jacobi_inverse
    from fvens_tpu.solver.relaxation import get_update_scheme

    for size in args.sizes:
        ni, nj = (int(x) for x in size.split("x"))
        case, mesh, u0 = build_case(ni, nj, platform=args.platform)
        space = build_space(case.cfg)
        bl = banded_structure(mesh)
        mesh32 = mesh.astype(jnp.float32)
        u32 = u0.astype(jnp.float32)
        phy = space.phy

        # the mesh and Jacobian blocks enter as jit ARGUMENTS (closed-over
        # constants are embedded in the program as literals)
        def residual_f64(m, u):
            return space.compute_residual(m, u, True)

        def assembly_f32(m, u):
            jac = space.assemble_jacobian(m, u)
            rhs32, dt32 = space.compute_residual(m, u, True)
            return jacmod.add_pseudotime_term(
                m, jac, jnp.asarray(500.0, jnp.float32),
                dt32).D.sum()

        jac0 = jax.jit(space.assemble_jacobian)(mesh32, u32)

        def banded_setup(blx, jac_d, jac_n):
            Dinv = block_jacobi_inverse(jac_d)
            return (banded_blocks(blx, jac_n).sum()
                    + banded_dn_blocks(blx, Dinv, jac_n).sum())

        du64 = jnp.ones_like(u0) * 1e-6

        def update_f64(u, du64):
            omega = get_update_scheme("full")(phy, u, du64, 0.1)
            rho0 = u[:, 0]
            p0 = phy.pressure(u)

            def positive(om):
                ut = u + (omega * om)[:, None] * du64
                return (ut[:, 0] > 0.01 * rho0) & (phy.pressure(ut)
                                                   > 0.01 * p0)
            scale = jnp.zeros_like(omega)
            for om in (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125):
                scale = jnp.where((scale == 0.0) & positive(om), om, scale)
            return u + (omega * scale)[:, None] * du64

        probes = (("residual_f64", residual_f64, (mesh, u0)),
                  ("assembly_f32", assembly_f32, (mesh32, u32)),
                  ("banded_setup", banded_setup, (bl, jac0.D, jac0.N)),
                  ("update_f64", update_f64, (u0, du64)))
        out = {"size": size, "cells": mesh.n_cells, "reps": args.reps,
               "platform": jax.devices()[0].platform,
               "banded": bl is not None}
        for name, f, a in probes:
            if name == "banded_setup" and bl is None:
                continue
            fj = jax.jit(f)
            jax.block_until_ready(fj(*a))      # compile
            t0 = time.perf_counter()
            for _ in range(args.reps):
                r = fj(*a)
            jax.block_until_ready(r)
            out[f"{name}_ms"] = (time.perf_counter() - t0) / args.reps * 1e3
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
