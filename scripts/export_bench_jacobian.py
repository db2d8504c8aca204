"""Export REAL bench-case Jacobians + rhs for the native C++ microbenchmark
of the reference's linear stack (scripts/cpu_ref_linear.cpp).

Grounds the 10x CPU bar empirically: the
reference's per-step linear work is BSR ILU0 factorization + L/U triangular
solves + SpMV inside FGMRES(30) at rtol 1e-1 (FVENS src/linalg/alinalg.cpp
:301-384 installing BLASTed/PETSc ILU0; testcases/defaults.solverc:10-17 and
visc-naca0012/opts.solverc for the settings). Measuring that stack on the
ACTUAL mid-solve Jacobian of the bench case replaces the vacuous analytic
roofline bound (BASELINE_CPU_BOUND.json) with a measured anchor.

What is exported:
  - visc-naca0012 (the 13,156-cell driver case): pseudo-time snapshots at
    steps {5, 40, 75} of the 79-step bench trajectory (freestream init,
    exp-residual CFL ramp 500->5000 — the same controller arithmetic as
    the bench solve, minus its recovery logic, which never fires on this
    case). The Jacobian is assembled in f64 WITH the pseudo-time diagonal
    at that step's (cfl, dt) — exactly the matrix the reference hands to
    PETSc each step (aodesolver.cpp:452-483).
  - --bigmesh: the 204.8k-cell inviscid-cylinder Jacobian (the
    BENCH_BIGMESH case) at a perturbed-freestream state, CFL 500 — at this
    size the 126 MB matrix no longer fits in any LLC, so the CPU-side
    bandwidth regime flips; the matrix STRUCTURE (which is what ILU0/SpMV
    timing depends on) is the real mesh's.

Matrix ordering: RCM (the reference's default, defaults.solverc
-mesh_reorder rcm) applied to the mesh before compilation, so the exported
sparsity is what PETSc would factor.

Binary format 'FVJ1' (little-endian):
  int64 magic(0x31'4a'56'46 = "FVJ1"), int64 n (block rows), int64 nnzb,
  int64 bs(=4); int32 indptr[n+1]; int32 indices[nnzb] (sorted per row);
  f64 data[nnzb*bs*bs] (row-major 4x4 blocks); f64 rhs[n*bs].

Artifacts land in /tmp/fvens_jac/ (not committed: ~8 MB each at 13k,
126 MB at 204.8k); the measured results + model live in
BASELINE_FVENS_EST.json via scripts/cpu_fvens_estimate.py.
"""

import argparse
import json
import os
import struct
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

MAGIC = 0x314A5646  # "FVJ1"


def to_bsr(mesh, jac, n):
    """Slot-block Jacobian -> standard BSR (indptr, indices, data).

    Vectorized (the per-cell Python loop took minutes at 819.2k cells):
    flatten the (self + valid neighbour) slots to COO, then lexsort by
    (row, col) to get sorted-per-row BSR."""
    nbrs = np.asarray(mesh.cell_nbrs)[:n]
    nmask = (np.asarray(mesh.nbr_mask)[:n] > 0) & (nbrs < n)
    D = np.asarray(jac.D)[:n]
    Nb = np.asarray(jac.N)[:n]
    S = nbrs.shape[1]
    rows_n, slots_n = np.nonzero(nmask)
    rows = np.concatenate([np.arange(n, dtype=np.int64), rows_n])
    cols = np.concatenate([np.arange(n, dtype=np.int64),
                           nbrs[rows_n, slots_n].astype(np.int64)])
    blks = np.concatenate([D, Nb[rows_n, slots_n]], axis=0)
    order = np.lexsort((cols, rows))
    rows, cols, blks = rows[order], cols[order], blks[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr.astype(np.int32), cols.astype(np.int32), blks


def write_fvj(path, indptr, indices, data, rhs):
    n = indptr.shape[0] - 1
    nnzb = indices.shape[0]
    with open(path, "wb") as f:
        f.write(struct.pack("<qqqq", MAGIC, n, nnzb, 4))
        indptr.astype("<i4").tofile(f)
        indices.astype("<i4").tofile(f)
        data.astype("<f8").tofile(f)
        np.asarray(rhs, "<f8").tofile(f)


def export_naca(outdir, snap_steps=(5, 40, 75)):
    import jax
    # force CPU via jax.config (the tests/conftest.py rule): the export is
    # platform-independent data
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from fvens_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from fvens_tpu.config import (BCSpec, FlowCaseConfig, LinearSolverConfig,
                                  NonlinearUpdateConfig, NumericsConfig,
                                  PhysicsConfig, PseudoTimeConfig)
    from fvens_tpu.cases.casesolvers import build_space, initial_state
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.mesh.reader import read_mesh
    from fvens_tpu.mesh.ordering import apply_ordering
    from fvens_tpu.solver import jacobian as jacmod
    from fvens_tpu.solver.steady import (SteadyBackwardEuler,
                                         controller_advance, residual_norm)

    ref_mesh = ("/root/reference/testcases/visc-naca0012/grids/"
                "NACA0012_lam_hybrid_1.msh")
    md = apply_ordering(read_mesh(ref_mesh), "rcm")   # the reference default

    pcfg = PhysicsConfig(Minf=0.5, Reinf=5000.0, Tinf=288.15, viscous=True)
    ncfg = NumericsConfig(flux="ROE", gradient="LEASTSQUARES",
                          reconstruction="LINEAR", order2=True)
    bcs = [BCSpec(marker=2, type="adiabaticwall", values=(0.0,)),
           BCSpec(marker=4, type="inflowoutflow")]
    cfg = FlowCaseConfig(physics=pcfg, numerics=ncfg, bcs=bcs)
    mesh = compile_mesh(md, bcs, dtype=jnp.float64)
    space = build_space(cfg)
    lin = LinearSolverConfig(restart=90, maxiter=90, rtol=1e-2,
                             mixed_precision=True, pc="bsgs", pc_sweeps=6)
    pt = PseudoTimeConfig(cfl_init=500.0, cfl_fin=5000.0, tol=1e-16,
                          tol_abs=1e-10, maxiter=600)
    solver = SteadyBackwardEuler(space, pt, lin,
                                 NonlinearUpdateConfig("full"))
    step = jax.jit(solver._step)
    lmesh = mesh.astype(jnp.float32)

    u = initial_state(space, mesh).astype(jnp.float64)
    # same controller initial state as SteadyBackwardEuler.solve
    cfl, cfl_cap = 500.0, float("inf")
    rtol = 0.1 if lin.rtol_adapt else lin.rtol
    rtol_floor, raise_relres = lin.rtol, 0.0
    res = resold = initres = None
    metas = []
    for k in range(1, max(snap_steps) + 1):
        u, resj, _ = step(mesh, u, cfl, rtol, lmesh=lmesh)
        res = float(resj)
        if initres is None:
            initres = resold = res
        if k in snap_steps:
            rhs, dt = space.compute_residual(mesh, u, True)
            jac = space.assemble_jacobian(mesh, u)
            jac = jacmod.add_pseudotime_term(mesh, jac, cfl, dt)
            n = mesh.n_cells
            indptr, indices, data = to_bsr(mesh, jac, n)
            name = f"naca13k_step{k:03d}.fvj"
            write_fvj(os.path.join(outdir, name), indptr, indices, data,
                      np.asarray(rhs)[:n])
            metas.append({"file": name, "case": "visc-naca0012",
                          "cells": n, "nnzb": int(indices.shape[0]),
                          "step": k, "cfl": cfl, "absres": res})
            print(f"  step {k}: cfl {cfl:.0f}, absres {res:.3e}, "
                  f"nnzb {indices.shape[0]}")
        cfl, cfl_cap, rtol, rtol_floor, raise_relres = controller_advance(
            pt, lin, np, cfl, cfl_cap, rtol, rtol_floor, raise_relres,
            res, resold, initres)
        resold = res
    return metas


def export_bigmesh(outdir, ni=640, nj=320):
    import jax
    jax.config.update("jax_platforms", "cpu")   # see export_naca
    jax.config.update("jax_enable_x64", True)
    from fvens_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from fvens_tpu.config import (BCSpec, FlowCaseConfig, NumericsConfig,
                                  PhysicsConfig)
    from fvens_tpu.cases.casesolvers import build_space, initial_state
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.mesh.meshgen import cylinder_omesh
    from fvens_tpu.mesh.ordering import apply_ordering
    from fvens_tpu.solver import jacobian as jacmod

    md = apply_ordering(cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj)),
                        "rcm")
    pcfg = PhysicsConfig(Minf=0.38, Tinf=288.15, viscous=False)
    ncfg = NumericsConfig(flux="HLLC", gradient="LEASTSQUARES",
                          reconstruction="LINEAR", order2=True)
    bcs = [BCSpec(marker=2, type="slipwall"),
           BCSpec(marker=4, type="farfield")]
    cfg = FlowCaseConfig(physics=pcfg, numerics=ncfg, bcs=bcs)
    mesh = compile_mesh(md, bcs, dtype=jnp.float64)
    space = build_space(cfg)

    # perturbed freestream: representative magnitudes, real structure
    rc = np.asarray(mesh.rc)
    pert = 1.0 + 0.02 * np.sin(rc[:, 0]) * np.cos(rc[:, 1])
    u = jnp.asarray(np.tile(np.asarray(space.uinf), (mesh.NC, 1))
                    * pert[:, None])
    rhs, dt = space.compute_residual(mesh, u, True)
    jac = space.assemble_jacobian(mesh, u)
    jac = jacmod.add_pseudotime_term(mesh, jac, 500.0, dt)
    n = mesh.n_cells
    print(f"  bigmesh: {n} cells, converting to BSR...")
    indptr, indices, data = to_bsr(mesh, jac, n)
    name = f"cyl{n // 1000}k_cfl500.fvj"
    write_fvj(os.path.join(outdir, name), indptr, indices, data,
              np.asarray(rhs)[:n])
    print(f"  wrote {name}: nnzb {indices.shape[0]}")
    return [{"file": name, "case": f"inv-cylinder-{ni}x{nj}", "cells": n,
             "nnzb": int(indices.shape[0]), "step": 1, "cfl": 500.0}]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/fvens_jac")
    ap.add_argument("--bigmesh", action="store_true",
                    help="also export the 204.8k-cell cylinder Jacobian")
    ap.add_argument("--bigmesh-only", action="store_true")
    ap.add_argument("--sizes", nargs="*", default=["640x320"],
                    help="cylinder O-mesh sizes for --bigmesh "
                         "(e.g. 640x320 1280x640)")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    metas = []
    if not args.bigmesh_only:
        print("exporting visc-naca0012 snapshots (CPU f64 steps)...")
        metas += export_naca(args.outdir)
    if args.bigmesh or args.bigmesh_only:
        for size in args.sizes:
            ni, nj = (int(x) for x in size.split("x"))
            print(f"exporting {ni * nj / 1000:.1f}k-cell cylinder Jacobian...")
            metas += export_bigmesh(args.outdir, ni, nj)

    try:
        rev = subprocess.run(["git", "-C", _ROOT, "rev-parse", "HEAD"],
                             capture_output=True, text=True,
                             check=True).stdout.strip()
    except Exception:
        rev = "unknown"
    # merge with an existing manifest (partial re-exports keep prior
    # entries whose files still exist and weren't re-exported)
    mpath0 = os.path.join(args.outdir, "manifest.json")
    if os.path.exists(mpath0):
        with open(mpath0) as f:
            old = json.load(f).get("matrices", [])
        new_files = {m["file"] for m in metas}
        metas = [m for m in old
                 if m["file"] not in new_files
                 and os.path.exists(os.path.join(args.outdir, m["file"]))
                 ] + metas
    manifest = {"git_rev": rev,
                "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "matrices": metas}
    mpath = os.path.join(args.outdir, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"wrote {mpath}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
