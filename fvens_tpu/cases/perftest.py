"""Preconditioner sweep benchmark harness.

Equivalent of the reference's threads_async perftest (FVENS
perftest/threads_async.cpp:5-18, threads_async_tests.cpp:102-330): sweep the
preconditioner configuration grid (kind x sweep counts x Krylov budget),
repeat each solve, and report averaged wall times and iteration counts.
Here the sweep axis is (preconditioner, color-sweeps) instead of
(threads, async build/apply sweeps).

Usage: python -m fvens_tpu.cases.perftest case.ctrl [--mesh_file m.msh]
           [--repeats 3] [--f32]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("control_file")
    ap.add_argument("--mesh_file", default=None)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--breakdown", action="store_true",
                    help="time the implicit-step kernels separately "
                         "(residual / Jacobian / pc apply / matvec), the "
                         "reference TimingData's per-component view")
    args = ap.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from ..compile_cache import enable_compile_cache
    from ..config import LinearSolverConfig
    from ..io_config import parse_control_file
    from .casesolvers import SteadyFlowCase, load_case_mesh
    enable_compile_cache()

    cfg0 = parse_control_file(args.control_file, mesh_file=args.mesh_file)
    dtype = jnp.float32 if args.f32 else jnp.float64
    mesh = load_case_mesh(cfg0, dtype=dtype)

    if args.breakdown:
        return kernel_breakdown(cfg0, mesh, args.repeats)

    grid = [
        ("bjacobi", 0, 60),
        ("bsgs", 2, 60),
        ("bsgs", 4, 60),
        ("bcsgs", 1, 30),
        ("bcsgs", 1, 60),
        ("bcsgs", 2, 60),
        ("bcsgs", 4, 60),
    ]
    results = []
    for pc, sweeps, kmax in grid:
        cfg = dataclasses.replace(cfg0, linear=LinearSolverConfig(
            restart=kmax, maxiter=kmax, rtol=1e-1, pc=pc, pc_sweeps=sweeps))
        case = SteadyFlowCase(cfg)
        walls, steps, its = [], [], []
        ok = True
        for rep in range(args.repeats):
            t0 = time.perf_counter()
            try:
                u, info, _ = case.run_output(mesh)
            except Exception as e:
                print(f"{pc}/{sweeps}/{kmax}: FAILED ({type(e).__name__})")
                ok = False
                break
            walls.append(time.perf_counter() - t0)
            steps.append(info.steps)
            its.append(info.total_lin_iters)
        if not ok:
            continue
        rec = {"pc": pc, "sweeps": sweeps, "krylov": kmax,
               "avg_wall_s": sum(walls) / len(walls),
               "min_wall_s": min(walls),
               "steps": steps[0], "total_lin_iters": its[0]}
        results.append(rec)
        print(json.dumps(rec), flush=True)

    if results:
        best = min(results, key=lambda r: r["min_wall_s"])
        print("# best:", json.dumps(best))
    return 0


def kernel_breakdown(cfg, mesh, repeats: int = 3) -> int:
    """Per-kernel timing of the implicit-step components (the reference's
    TimingData records the linear-solve walltime and apply counts,
    aodesolver.hpp:46-67; here each kernel is jitted and timed on device).
    Prints one JSONL record per kernel: {"kernel": ..., "ms": ...}."""
    import json
    import time

    import jax
    import jax.numpy as jnp

    from ..solver import jacobian as jacmod
    from ..solver.linear import bsr_matvec, make_preconditioner
    from .casesolvers import build_space, initial_state

    space = build_space(cfg)
    u = initial_state(space, mesh)

    rhs, dt = space.compute_residual(mesh, u, True)
    jac = space.assemble_jacobian(mesh, u)
    jac = jacmod.add_pseudotime_term(mesh, jac, jnp.asarray(100.0,
                                                            mesh.dtype), dt)
    pc = make_preconditioner(mesh, jac, cfg.linear.pc, cfg.linear.pc_sweeps)

    kernels = {
        "residual": jax.jit(lambda v: space.compute_residual(mesh, v,
                                                             True)[0]),
        "jacobian_assembly": jax.jit(
            lambda v: space.assemble_jacobian(mesh, v).D),
        "pc_apply": jax.jit(pc),
        "bsr_matvec": jax.jit(lambda v: bsr_matvec(mesh, jac, v)),
    }
    args = {"residual": u, "jacobian_assembly": u, "pc_apply": rhs,
            "bsr_matvec": rhs}

    for name, fn in kernels.items():
        a = args[name]
        jax.block_until_ready(fn(a))          # compile
        n = max(repeats, 3)
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(a)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / n * 1e3
        print(json.dumps({"kernel": name, "ms": ms,
                          "cells": mesh.n_cells}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
