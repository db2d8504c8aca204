"""Large-mesh benchmark: full adaptive implicit solves on generated
inviscid-cylinder O-meshes from ~50k to 819.2k cells.

The mesh is a jit ARGUMENT, so the program is O(1) in mesh size; this
script runs the >=200k-cell regime the reference handles routinely, where
the device's throughput shows (the 13k-cell case is latency-bound).

Case: the reference's inviscid 2dcylinder family (M 0.38, HLLC + WLS +
linear reconstruction) scaled up — chosen because it stays PHYSICALLY
steady at every resolution (see the note in build_case for why the
Re-5000 NACA case cannot be the large-mesh target). Reference-faithful
pipeline: first-order starter solve, then the implicit second-order main
solve (mixed precision, bsgs x6, FGMRES(90) rtol 1e-2, CFL 500->5000) to
rel 1e-6 or abs 1e-10, whichever first. Reports wall (compile excluded
via a warmup solve, same rule as bench.py) and cell-updates/s.
Writes/merges BENCH_BIGMESH.json at the repo root.

Usage:
  python scripts/bench_bigmesh.py --sizes 640x320 1280x640
  python scripts/bench_bigmesh.py --sizes 640x320 --cpu-rate-probe
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def build_case(ni, nj, platform=None, banded=False, pipeline=False,
               tol=1e-6, tol_abs=1e-10):
    """Reference-faithful case pipeline: first-order STARTER solve (loose
    tol, gentle CFL — casesolvers.cpp:225-314) then the second-order main
    solve. A cold CFL-500 second-order start from freestream blows up on
    the fine O-meshes (measured: 204.8k cells limit-cycles at CFL ~2 after
    the trust region fires); the starter is how the reference's own cases
    get past the transient."""
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    jax.config.update("jax_enable_x64", True)
    from fvens_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import dataclasses as dc

    import jax.numpy as jnp

    from fvens_tpu.cases.casesolvers import SteadyFlowCase, build_space, \
        initial_state
    from fvens_tpu.cases.flagship import cylinder_config, cylinder_mesh
    from fvens_tpu.mesh import compile_mesh

    # INVISCID 2D CYLINDER at M 0.38 (the reference's own 2dcylinder
    # grid-convergence family, scaled up; fvens_tpu/cases/flagship.py): the
    # viscous Re-5000 NACA case turns physically unsteady once the O-mesh
    # resolves the wake, and the NACA O-mesh blows up repeatedly at
    # CFL >~500 off the sharp trailing edge — the smooth subcritical
    # cylinder is steady and stiffness-friendly at every resolution while
    # exercising the same residual/Jacobian/solver pipeline.
    md = cylinder_mesh(ni, nj)
    cfg = cylinder_config()
    cfg = dc.replace(
        cfg, main=dc.replace(cfg.main, tol=tol, tol_abs=tol_abs, maxiter=600,
                             pipeline=pipeline),
        init=dc.replace(cfg.init, pipeline=pipeline),
        linear=dc.replace(cfg.linear, banded=banded))
    mesh = compile_mesh(md, cfg.bcs, dtype=jnp.float64)
    case = SteadyFlowCase(cfg)
    u0 = initial_state(build_space(cfg), mesh).astype(jnp.float64)
    return case, mesh, u0


def _two_phase_solve(case, mesh, u0, gate, tol, log_every):
    """Precision-scheduled solve (bench.py --two-phase at large scale):
    phase A runs starter+main FULLY in f32 (state, residual, controller)
    down to absolute residual `gate`; phase B casts up and continues in
    f64 (mixed f32 Krylov) to the target, starting its CFL ramp at phase
    A's final CFL. Returns solve() -> (u, info) with combined counts."""
    import dataclasses as dc
    import jax
    import jax.numpy as jnp
    from fvens_tpu.cases.casesolvers import SteadyFlowCase, build_space

    mesh32 = mesh.astype(jnp.float32)
    cfgA = dc.replace(case.cfg, main=dc.replace(case.cfg.main,
                                                tol=1e-16, tol_abs=gate))
    caseA = SteadyFlowCase(cfgA)
    # ONE phase-B solver reused across warmup+timed calls (its jitted step
    # does not depend on PseudoTimeConfig; a fresh solver would retrace
    # inside the measured solve — bench.py run_solve has the same note)
    solverB = case._make_solver(build_space(case.cfg), case.cfg.main)
    u032 = u0.astype(jnp.float32)

    def solve():
        uA, infoA = caseA.solve(mesh32, u032, log_every=log_every)
        cflB = (infoA.history[-1][3] if infoA.history
                else case.cfg.main.cfl_init)
        solverB.cfg = dc.replace(case.cfg.main, cfl_init=float(cflB))
        u, info = solverB.solve(mesh, uA.astype(jnp.float64),
                                log_every=log_every)
        jax.block_until_ready(u)
        info.steps += infoA.steps
        info.total_lin_iters += infoA.total_lin_iters
        return u, info

    return solve


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", nargs="+", default=["640x320"],
                    help="O-mesh dims ni x nj (cells = 4*ni*nj/... see "
                         "meshgen); e.g. 160x80 320x160 640x320 1280x640")
    ap.add_argument("--platform", default=None,
                    help="force jax platform (default: best available)")
    ap.add_argument("--cpu-rate-probe", action="store_true",
                    help="also time 3 implicit steps on the host CPU for a "
                         "rate (NOT a full solve; hours at these sizes)")
    ap.add_argument("--probe-only", action="store_true",
                    help="skip the full solves (use with --cpu-rate-probe)")
    ap.add_argument("--banded", action="store_true",
                    help="banded (shifted-slice) neighbour encoding for the "
                         "matvec/smoother (LinearSolverConfig.banded): the "
                         "generated O-meshes are 100%% band-coverable, so "
                         "the per-Krylov-iteration gather becomes contiguous "
                         "rolls (solver/banded.py)")
    ap.add_argument("--pipeline", action="store_true",
                    help="software-pipelined host stepping (dispatch k+1 "
                         "before fetching k; hides the per-step host "
                         "round trip, trajectory-identical)")
    ap.add_argument("--stop", choices=["dual", "abs"], default="dual",
                    help="stopping rule: 'dual' = rel 1e-6 OR abs 1e-10 "
                         "whichever first (the scaling-study rule); 'abs' "
                         "= abs 1e-10 only (the BASELINE.md driver rule)")
    ap.add_argument("--two-phase", type=float, default=0.0, nargs="?",
                    const=1e-3, dest="two_phase",
                    help="precision scheduling: run starter+main fully in "
                         "f32 down to this ABSOLUTE residual, then continue "
                         "in f64 (mixed Krylov) to the target")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(_ROOT,
                                                  "BENCH_BIGMESH.json"))
    args = ap.parse_args()

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f).get("runs", [])

    tol = 1e-16 if args.stop == "abs" else 1e-6

    import jax
    for size in args.sizes if not args.probe_only else []:
        ni, nj = (int(x) for x in size.split("x"))
        case, mesh, u0 = build_case(ni, nj, platform=args.platform,
                                    banded=args.banded,
                                    pipeline=args.pipeline, tol=tol)
        platform = jax.devices()[0].platform
        print(f"--- {size}: {mesh.n_cells} cells on {platform} "
              f"(stop={args.stop}, pipeline={args.pipeline}, "
              f"two_phase={args.two_phase})")

        if args.two_phase:
            solve = _two_phase_solve(case, mesh, u0, args.two_phase, tol,
                                     args.log_every)
        else:
            def solve():
                u, info = case.solve(mesh, u0, log_every=args.log_every)
                jax.block_until_ready(u)
                return u, info

        t0 = time.perf_counter()
        u, info = solve()
        wall_cold = time.perf_counter() - t0

        t0 = time.perf_counter()
        u, info = solve()
        wall = time.perf_counter() - t0
        # wall includes the first-order starter solve; steps/lin_iters are
        # the MAIN solve's (SolveInfo comes from execute_main)

        rec = {
            "size": size, "cells": mesh.n_cells, "platform": platform,
            "banded": bool(args.banded), "pipeline": bool(args.pipeline),
            "stop": args.stop,
            "wall_s": wall, "wall_incl_compile_s": wall_cold,
            "steps": info.steps, "lin_iters": info.total_lin_iters,
            "relres": info.finalres / info.initres,
            "absres": info.finalres,
            "cell_updates_per_sec": mesh.n_cells * info.steps / wall,
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        if args.two_phase:
            rec["two_phase_gate"] = args.two_phase
        print(json.dumps(rec))
        results = [r for r in results
                   if not (r["size"] == size and r["platform"] == platform
                           and bool(r.get("banded")) == bool(args.banded)
                           and r.get("stop", "dual") == args.stop
                           and bool(r.get("two_phase_gate"))
                           == bool(args.two_phase))]
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump({"runs": results}, f, indent=1)

    if args.cpu_rate_probe:
        # a 3-step rate probe on the host CPU (full CPU solves at these
        # sizes take hours; the probe gives the honest rate comparison)
        import jax
        for size in args.sizes:
            ni, nj = (int(x) for x in size.split("x"))
            case, mesh, u0 = build_case(ni, nj, platform="cpu")
            import jax.numpy as jnp
            from fvens_tpu.cases.casesolvers import build_space
            solver = case._make_solver(build_space(case.cfg), case.cfg.main)
            step = jax.jit(solver._step)
            lmesh = mesh.astype(jnp.float32)
            u, r, it = step(mesh, u0, 500.0, 1e-2, lmesh=lmesh)  # compile
            jax.block_until_ready(u)
            t0 = time.perf_counter()
            nprobe = 3
            for _ in range(nprobe):
                u, r, it = step(mesh, u, 500.0, 1e-2, lmesh=lmesh)
            jax.block_until_ready(u)
            dt = (time.perf_counter() - t0) / nprobe
            rec = {
                "size": size, "cells": mesh.n_cells, "platform": "cpu",
                "probe_steps": nprobe, "s_per_step": dt,
                "cell_updates_per_sec": mesh.n_cells / dt,
                "rate_probe": True,
                "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            }
            print(json.dumps(rec))
            results = [r for r in results
                       if not (r.get("rate_probe")
                               and r["size"] == size)]
            results.append(rec)
            with open(args.out, "w") as f:
                json.dump({"runs": results}, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
