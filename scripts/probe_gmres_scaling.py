"""Time the Krylov phase's parts at large mesh sizes against their
streaming bounds, on real assembled f32 Jacobians of the inviscid cylinder:

  matvec   banded matvec applied R times back-to-back (one jit program)
  gather   slot-gather BSR matvec (solver/linear.py) applied R times
  pc       banded bsgs x sweeps applied R times; sweep = one more sweep
  gmres    one full gmres(restart) call at fixed iteration count
           (--trace DIR: its device kernels from a jax.profiler trace)

Each timing is one device program (lax.fori_loop over applies), so the
per-call host round trip is excluded. The streaming bound of an apply is
the bytes it must move (band blocks K*16*NC*4 B plus the state vectors)
over the device copy bandwidth measured in the same process
(`copy_GBps`, a large x -> 1.0001 x). Usage:

    python scripts/probe_gmres_scaling.py --sizes 320x160 640x320 1280x640
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
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--restart", type=int, default=90)
    ap.add_argument("--sweeps", type=int, default=6)
    ap.add_argument("--trace", default=None,
                    help="profile one gmres call per size into this "
                         "directory and list its largest device kernels")
    ap.add_argument("--classic", action="store_true",
                    help="force the classic CGS2 gmres basis path "
                         "(blocked=False) for before/after A-B records")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)
    from fvens_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from scripts.bench_bigmesh import build_case
    from fvens_tpu.cases.casesolvers import build_space, initial_state
    from fvens_tpu.solver import jacobian as jacmod
    from fvens_tpu.solver.banded import (banded_dn_blocks, banded_structure,
                                         make_banded_bsgs,
                                         make_banded_matvec, banded_blocks)
    from fvens_tpu.solver.linear import (block_jacobi_inverse, gmres,
                                         make_bsr_matvec)

    big = jnp.ones((1 << 28,), jnp.float32)          # 1 GiB
    cp = jax.jit(lambda x: x * 1.0001)
    jax.block_until_ready(cp(big))
    t0 = time.perf_counter()
    for _ in range(10):
        y = cp(big)
    jax.block_until_ready(y)
    bw = 2 * big.nbytes * 10 / (time.perf_counter() - t0)
    del big, y
    print(f"# copy bandwidth {bw / 1e9:.1f} GB/s", flush=True)

    for size in args.sizes:
        ni, nj = (int(x) for x in size.split("x"))
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
            jac = jacmod.add_pseudotime_term(m, jac, 500.0, dt)
            return rhs.astype(jnp.float32), jac

        rhs, jac = setup(mesh32, u32)
        jax.block_until_ready(rhs)

        @jax.jit
        def run_gather(x, m, jac):
            mv = make_bsr_matvec(m, jac)
            return jax.lax.fori_loop(0, args.reps, lambda i, v: mv(v), x)

        jax.block_until_ready(run_gather(rhs, mesh32, jac))   # compile
        t0 = time.perf_counter()
        jax.block_until_ready(run_gather(rhs, mesh32, jac))
        gather_ms = (time.perf_counter() - t0) / args.reps * 1e3

        # big operands enter as jit ARGUMENTS, not closures: closed-over
        # constants are embedded in the program as literals
        Bt = jax.jit(banded_blocks)(bl, jac.N)
        Dinv = jax.jit(block_jacobi_inverse)(jac.D)
        DNbt = jax.jit(banded_dn_blocks)(bl, Dinv, jac.N)
        offsets = bl.offsets
        # free dead device buffers before the big allocations: the slot
        # Jacobian N (210 MB at 819k) is superseded by Bt/DNbt, and the f64
        # mesh/state used only for assembly (HBM headroom at 819.2k cells)
        D = jac.D
        del jac
        u0 = u32 = mesh32 = None
        jax.block_until_ready((Bt, DNbt))
        print(f"# {size}: setup done, {len(offsets)} bands", flush=True)

        @jax.jit
        def run_mv(x, D, B):
            mv = make_banded_matvec(D, B, offsets)
            return jax.lax.fori_loop(0, args.reps, lambda i, v: mv(v), x)

        def run_pc_n(sweeps):
            @jax.jit
            def run_pc(x, Di, DN):
                pc = make_banded_bsgs(Di, DN, offsets, sweeps)
                return jax.lax.fori_loop(0, args.reps, lambda i, v: pc(v), x)
            return run_pc

        NC, K = mesh.NC, len(offsets)
        mv_bytes = (K + 1) * 16 * NC * 4 + 2 * 4 * NC * 4
        sweep_bytes = K * 16 * NC * 4 + 3 * 4 * NC * 4
        dev = jax.devices()[0]
        out = {"size": size, "cells": mesh.n_cells, "reps": args.reps,
               "restart": args.restart, "sweeps": args.sweeps,
               "gmres_path": "classic" if args.classic else "auto",
               "platform": dev.platform, "device_kind": dev.device_kind,
               "copy_GBps": bw / 1e9,
               "gather_matvec_ms_per_apply": gather_ms,
               "matvec_bound_ms": mv_bytes / bw * 1e3,
               "sweep_bound_ms": sweep_bytes / bw * 1e3}
        for name, run, ops in (("matvec", run_mv, (D, Bt)),
                               ("pc", run_pc_n(args.sweeps), (Dinv, DNbt)),
                               ("pc1", run_pc_n(1), (Dinv, DNbt))):
            jax.block_until_ready(run(rhs, *ops))          # compile
            t0 = time.perf_counter()
            jax.block_until_ready(run(rhs, *ops))
            out[f"{name}_ms_per_apply"] = (
                (time.perf_counter() - t0) / args.reps * 1e3)
            print(f"# {size}: {name} done", flush=True)

        @jax.jit
        def one_solve(b, D, B, Di, DN):
            mv = make_banded_matvec(D, B, offsets)
            pc = make_banded_bsgs(Di, DN, offsets, args.sweeps)
            x, iters, relres = gmres(mv, b, jnp.zeros_like(b), pc,
                                     restart=args.restart,
                                     maxiter=args.restart, rtol=1e-30,
                                     blocked=False if args.classic else None)
            return x, iters, relres

        out["sweep_ms"] = ((out["pc_ms_per_apply"] - out["pc1_ms_per_apply"])
                           / max(args.sweeps - 1, 1))
        out["matvec_over_bound"] = (out["matvec_ms_per_apply"]
                                    / out["matvec_bound_ms"])
        out["sweep_over_bound"] = out["sweep_ms"] / out["sweep_bound_ms"]

        ops = (D, Bt, Dinv, DNbt)
        jax.block_until_ready(one_solve(rhs, *ops))      # compile
        t0 = time.perf_counter()
        x, iters, relres = one_solve(rhs, *ops)
        jax.block_until_ready(x)
        gm = time.perf_counter() - t0
        if args.trace:
            from scripts.probe_ortho import trace_kernels
            out["gmres_kernels"] = trace_kernels(
                lambda b: one_solve(b, *ops)[0], rhs,
                os.path.join(args.trace, size), top=12)
        out["gmres_iters"] = int(iters)
        out["gmres_ms_per_iter"] = gm / max(int(iters), 1) * 1e3
        out["ortho_ms_per_iter"] = (
            out["gmres_ms_per_iter"] - out["matvec_ms_per_apply"]
            - out["pc_ms_per_apply"])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
