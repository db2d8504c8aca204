"""Re-price the preconditioner space at large mesh sizes.

The cost of a sweep depends on the layout (slot gather or banded) and the
device, and the Gram-Schmidt basis cost per Krylov iteration grows with
the iteration count — so the sweeps-vs-iterations optimum must be
measured on the device, not assumed.

For each (pc, sweeps, restart) configuration this runs ONE right-
preconditioned GMRES solve to the solver's Krylov floor (rtol 1e-2) on
the REAL assembled Jacobian of the bigmesh case at a mid-ramp state, and
reports iterations and wall — the product the implicit step actually
pays. Usage:

    python scripts/probe_pc_sweep.py --size 640x320
    python scripts/probe_pc_sweep.py --size 1280x640 --configs bsgs:6:90 bsgs:12:45
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

DEFAULT_CONFIGS = [
    "bjacobi:1:90",
    "bsgs:4:90", "bsgs:6:90", "bsgs:8:90", "bsgs:12:90",
    "bsgs:6:45", "bsgs:8:45", "bsgs:12:45", "bsgs:16:45",
    "bsgs:6:30", "bsgs:12:30",
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="640x320")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--rtol", type=float, default=1e-2)
    ap.add_argument("--maxiter", type=int, default=270)
    ap.add_argument("--cfl", type=float, default=5000.0,
                    help="pseudo-time CFL for the probed Jacobian: the "
                         "endgame (high-CFL) solves are where iterations "
                         "pile up, so price the PCs there")
    ap.add_argument("--configs", nargs="*", default=DEFAULT_CONFIGS,
                    help="pc:sweeps:restart triples")
    ap.add_argument("--out", default=None)
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
    from fvens_tpu.solver.banded import (banded_dn_blocks, banded_structure,
                                         banded_blocks)
    from fvens_tpu.solver.linear import block_jacobi_inverse, gmres
    from fvens_tpu.solver.banded import make_banded_bsgs, make_banded_matvec
    from fvens_tpu.solver.precision import einsum

    ni, nj = (int(x) for x in args.size.split("x"))
    case, mesh, u0 = build_case(ni, nj, platform=args.platform)
    space = build_space(case.cfg)
    bl = banded_structure(mesh)
    assert bl is not None
    mesh32 = mesh.astype(jnp.float32)
    u32 = u0.astype(jnp.float32)

    @jax.jit
    def setup(m, u):
        rhs, dt = space.compute_residual(m, u, True)
        jac = space.assemble_jacobian(m, u)
        jac = jacmod.add_pseudotime_term(m, jac, args.cfl, dt)
        return rhs.astype(jnp.float32), jac

    rhs, jac = setup(mesh32, u32)
    Bt = jax.jit(banded_blocks)(bl, jac.N)
    Dinv = jax.jit(block_jacobi_inverse)(jac.D)
    DNbt = jax.jit(banded_dn_blocks)(bl, Dinv, jac.N)
    offsets = bl.offsets
    D = jac.D
    del jac
    jax.block_until_ready((Bt, DNbt, rhs))
    print(f"# {args.size}: NC={mesh.n_cells}", flush=True)

    results = []
    for cfgs in args.configs:
        pc_kind, sweeps, restart = cfgs.split(":")
        sweeps, restart = int(sweeps), int(restart)

        @jax.jit
        def one_solve(b, D, B, Di, DN):
            mv = make_banded_matvec(D, B, offsets)
            if pc_kind == "bjacobi":
                pc = lambda v: einsum("cij,cj->ci", Di, v)
            else:
                pc = make_banded_bsgs(Di, DN, offsets, sweeps)
            return gmres(mv, b, jnp.zeros_like(b), pc, restart=restart,
                         maxiter=args.maxiter, rtol=args.rtol)

        ops = (D, Bt, Dinv, DNbt)
        x, iters, relres = one_solve(rhs, *ops)
        jax.block_until_ready(x)                     # compile
        t0 = time.perf_counter()
        x, iters, relres = one_solve(rhs, *ops)
        jax.block_until_ready(x)
        wall = time.perf_counter() - t0
        rec = {"size": args.size, "cells": mesh.n_cells, "pc": pc_kind,
               "sweeps": sweeps, "restart": restart, "rtol": args.rtol,
               "cfl": args.cfl, "iters": int(iters),
               "relres": float(relres), "wall_s": wall,
               "ms_per_iter": wall / max(int(iters), 1) * 1e3,
               "platform": jax.devices()[0].platform,
               "device_kind": jax.devices()[0].device_kind}
        print(json.dumps(rec), flush=True)
        results.append(rec)

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"probe": "pc_sweep", "runs": results}, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
