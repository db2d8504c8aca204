"""Defensible single-socket-CPU FVENS baseline bound (BASELINE.md metric).

The reference cannot be built here (no PETSc/Boost/Eigen/Scotch in the
image, and installs are not allowed), so the 10x bar is checked against an
ANALYTIC LOWER BOUND on the reference's wall-clock: per-step FLOP and DRAM
byte counts of the reference algorithm (FVENS implicit BE: residual +
Jacobian + ILU0 factorization + FGMRES with ILU0 applies — SURVEY.md
sec 3.2-3.5, testcases/defaults.solverc) divided by a GENEROUS single-socket
roofline. Every modeling choice errs in the CPU's favour, so

    T_cpu_fvens >= T_bound   =>   vs_baseline_bound = (T_bound/10)/T_dev

is an honest lower bound on the true vs-FVENS ratio (and bench.py also
reports the measured JAX-CPU stand-in, which bounds it from the other side).

Roofline: scripts/cpu_roofline.cpp measures this host's PER-CORE sustained
triad bandwidth and f64 FMA rate; the socket model scales by
SOCKET_CORES (default 64, a 2024-era high-core-count single socket) with
PERFECT OpenMP scaling for flops, and uses SOCKET_BW (default 460 GB/s,
12-channel DDR5-4800 — the fastest mainstream single socket) for DRAM.
Sparse unstructured solvers do not hit either ceiling; assuming they do is
what makes this a bound.

Cost model per pseudo-time step (N cells, 2-D hybrid mesh):
  faces F ~= 2N; block-nonzeros nnzb ~= 4.8N (diag + ~3.8 neighbours);
  4x4 f64 blocks = 128 B.
  - residual (2nd-order viscous: WLS gradients + reconstruction + Roe +
    viscous):       ~1000 flop/face            -> 2000N flop
  - Jacobian assembly (analytic flux+viscous Jacobians, 2 blocks/face):
                    ~1500 flop/face            -> 3000N flop
  - ILU0 factorization: per row ~nnz_row 4x4 GEMM+inv ~ 700 flop/block
                                               -> ~3400N flop,
    traffic 2x matrix (read+write)
  - k FGMRES iters, each: BSR SpMV (32 flop/block-element) + L,U solves
    (same class)    -> ~300N flop/iter, traffic 2x matrix stream/iter
  Steps and k: the device solve's own step count (same algorithm family, same
  CFL schedule) and k=5 Krylov iters/step for ILU0+FGMRES at rtol 1e-1
  (flattering to the CPU: fewer iterations = less work; our weaker PC needs
  ~68). Matrix streams are charged to DRAM only when the matrix exceeds
  LLC_MB (generous 128 MB LLC): below that the byte term is dropped
  entirely and only the flop ceiling binds.

Usage:
  g++ -O3 -march=native -funroll-loops scripts/cpu_roofline.cpp -o /tmp/roofline
  /tmp/roofline > /tmp/roofline.json
  python scripts/cpu_bound.py --cells 13156 --steps 79 \
      --roofline /tmp/roofline.json --out BASELINE_CPU_BOUND.json
"""

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOCKET_CORES = 64          # generous high-core-count single socket
SOCKET_BW_GBS = 460.0      # 12ch DDR5-4800 theoretical peak
LLC_MB = 128.0             # generous last-level cache


def bound_seconds(cells: int, steps: int, k_iters: float,
                  core_gflops: float, *, socket_cores: int = SOCKET_CORES,
                  socket_bw_gbs: float = SOCKET_BW_GBS) -> dict:
    N = float(cells)
    nnzb = 4.8 * N
    matrix_bytes = nnzb * 128.0

    flops_per_step = (2000.0 * N            # residual
                      + 3000.0 * N          # Jacobian assembly
                      + 3400.0 * N          # ILU0 factorization
                      + k_iters * 300.0 * N)  # SpMV + L/U solves per iter
    # DRAM traffic only if the matrix cannot live in LLC
    if matrix_bytes > LLC_MB * 1e6:
        bytes_per_step = matrix_bytes * (1.0     # assembly write
                                         + 2.0   # ILU0 fact read+write
                                         + 2.0 * k_iters)  # SpMV + ILU apply
    else:
        bytes_per_step = 0.0

    socket_gflops = core_gflops * socket_cores   # perfect scaling (generous)
    t_flops = steps * flops_per_step / (socket_gflops * 1e9)
    t_bytes = steps * bytes_per_step / (socket_bw_gbs * 1e9)
    return {
        "t_bound_s": max(t_flops, t_bytes),
        "t_flops_s": t_flops,
        "t_bytes_s": t_bytes,
        "binding": "memory" if t_bytes > t_flops else "flops",
        "matrix_mb": matrix_bytes / 1e6,
        "flops_per_step": flops_per_step,
        "bytes_per_step": bytes_per_step,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, required=True)
    ap.add_argument("--steps", type=int, required=True,
                    help="pseudo-time steps of the measured device solve")
    ap.add_argument("--k_iters", type=float, default=5.0,
                    help="assumed FGMRES iters/step for ILU0 at rtol 1e-1")
    ap.add_argument("--roofline", default="/tmp/roofline.json",
                    help="output of scripts/cpu_roofline.cpp")
    ap.add_argument("--socket_cores", type=int, default=SOCKET_CORES)
    ap.add_argument("--socket_bw", type=float, default=SOCKET_BW_GBS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    with open(args.roofline) as f:
        roof = json.load(f)

    rec = bound_seconds(args.cells, args.steps, args.k_iters,
                        roof["fma_gflops_per_core"],
                        socket_cores=args.socket_cores,
                        socket_bw_gbs=args.socket_bw)
    rec.update({
        "cells": args.cells, "steps": args.steps, "k_iters": args.k_iters,
        "core_gflops": roof["fma_gflops_per_core"],
        "core_triad_gbs": roof["triad_gbs_per_core"],
        "socket_cores": args.socket_cores,
        "socket_bw_gbs": args.socket_bw,
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    })
    try:
        rec["git_rev"] = subprocess.run(
            ["git", "-C", _ROOT, "rev-parse", "HEAD"], capture_output=True,
            text=True, check=True).stdout.strip()
    except Exception:
        rec["git_rev"] = "unknown"
    print(json.dumps(rec, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
