"""Krylov iterations per implicit step on the accelerator beside the CPU's
count for the same step, so that any drift caused by the device's
arithmetic (summation order, matmul precision) is visible.

The inviscid cylinder (fvens_tpu/cases/flagship.py, mixed precision,
banded bsgs x6, FGMRES(90)) runs its first-order starter on the default
device; from that state, `--steps` main steps at fixed CFL and Krylov
tolerance run once on the default device and once on the process's CPU
device, each from the same starting state.

Usage: python scripts/probe_krylov_drift.py [--size 640x320] [--steps 5]
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
    ap.add_argument("--size", default="640x320")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--cfl", type=float, default=500.0)
    ap.add_argument("--rtol", type=float, default=1e-2)
    args = ap.parse_args()

    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax
    import jax.numpy as jnp

    from fvens_tpu.cases.casesolvers import (SteadyFlowCase, build_space,
                                             initial_state)
    from fvens_tpu.cases.flagship import cylinder_config, cylinder_mesh
    from fvens_tpu.compile_cache import enable_compile_cache
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.solver.banded import banded_structure

    enable_compile_cache()
    ni, nj = (int(x) for x in args.size.split("x"))
    cfg = cylinder_config()
    mesh = compile_mesh(cylinder_mesh(ni, nj), cfg.bcs, dtype=jnp.float64)
    space = build_space(cfg)
    case = SteadyFlowCase(cfg)
    u = case.execute_starter(mesh, initial_state(space, mesh))
    solver = case._make_solver(space, cfg.main)
    step = jax.jit(solver._step)
    bl = banded_structure(mesh)

    out = {"size": args.size, "cells": mesh.n_cells, "cfl": args.cfl,
           "rtol": args.rtol}
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        m, uu, b = jax.device_put((mesh, u, bl), dev)
        lm = m.astype(jnp.float32)
        its, res = [], []
        t0 = time.perf_counter()
        for _ in range(args.steps):
            uu, r, it = step(m, uu, args.cfl, args.rtol, lmesh=lm, bl=b)
            its.append(int(it))
            res.append(float(r))
        key = dev.platform
        out[f"{key}_kind"] = dev.device_kind
        out[f"{key}_iters"] = its
        out[f"{key}_res"] = res
        out[f"{key}_wall_s"] = time.perf_counter() - t0
        print(f"# {key} ({dev.device_kind}): Krylov iterations per step "
              f"{its}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
