"""fvens_steady-equivalent CLI.

Usage:  python -m fvens_tpu.cases.cli case.ctrl [--mesh_file m.msh]
            [--platform cpu|gpu] [--f32] [--vtu out.vtu]

Mirrors the reference driver (FVENS src/fvens_steady.cpp:15-57): parse the
control file, build the mesh, free-stream init, starter + main solve, then
write functionals, surface data and VTU output.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="fvens_tpu steady flow solver")
    ap.add_argument("control_file")
    ap.add_argument("--mesh_file", default=None,
                    help="override the control file's mesh")
    ap.add_argument("-options_file", "--options_file", default=None,
                    help="PETSc-style .solverc options file (the reference's "
                         "-options_file flag): ksp/pc settings are mapped "
                         "onto this solver's linear stack")
    ap.add_argument("--platform", default=None,
                    help="jax platform override (cpu, gpu)")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32")
    ap.add_argument("--vtu", default=None, help="write VTU solution here")
    ap.add_argument("--surface", default=None,
                    help="write wall surface data (x y Cp Cf) here")
    ap.add_argument("--volume", default=None,
                    help="write volume data (x y rho vx vy p T Mach) here")
    ap.add_argument("--history", default=None,
                    help="write convergence history (JSONL) here")
    ap.add_argument("--functionals_every", type=int, default=0,
                    help="log device-evaluated functionals "
                         "(entropy/CL/CDp/CDsf) to the history every N "
                         "steps (0 = off); the evaluation runs fully on "
                         "device and joins the step's fused fetch")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint/resume the main solve at this path")
    ap.add_argument("--mesh_reorder", default="none",
                    choices=["none", "rcm", "line", "line_rcm"],
                    help="cell reordering (reference -mesh_reorder)")
    ap.add_argument("--mesh_anisotropy_threshold", type=float, default=None,
                    help="minimum local grid anisotropy for a cell to join "
                         "a line under line orderings (reference "
                         "-mesh_anisotropy_threshold, doc/user-doc.md:22; "
                         "default 10.0)")
    ap.add_argument("--devices", type=int, default=0,
                    help="run domain-decomposed over N devices (the "
                         "reference's mpirun -n N; 0 = single device)")
    ap.add_argument("--pipeline", action="store_true",
                    help="software-pipelined host stepping: dispatch step "
                         "k+1 before fetching step k's residual (hides the "
                         "per-step host round trip; trajectory-identical)")
    ap.add_argument("--log_every", type=int, default=10)
    args = ap.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from ..compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"fvens_tpu: running on {dev.platform} ({dev.device_kind}), "
          f"{len(jax.devices())} device(s)")

    from ..io_config import parse_control_file, write_vtu
    from ..mesh.reader import read_mesh
    from ..mesh.device_mesh import compile_mesh
    from .casesolvers import SteadyFlowCase, build_space
    from ..output import surface_data, entropy_error

    import dataclasses as _dc
    cfg = parse_control_file(args.control_file, mesh_file=args.mesh_file)
    if args.options_file:
        from ..io_config.solverc import load_solver_options
        lin, reorder, aniso = load_solver_options(
            args.options_file, base=cfg.linear,
            warn=lambda m: print(f"fvens_tpu: {m}"))
        cfg = _dc.replace(cfg, linear=lin)
        if args.mesh_reorder == "none" and reorder:
            args.mesh_reorder = reorder
        if args.mesh_anisotropy_threshold is None and aniso is not None:
            args.mesh_anisotropy_threshold = aniso
        print(f"fvens_tpu: solver options from {args.options_file}: "
              f"pc={lin.pc}, restart={lin.restart}, maxiter={lin.maxiter}, "
              f"rtol={lin.rtol}"
              + (f", reorder={reorder}" if reorder else ""))
    if args.checkpoint:
        cfg = _dc.replace(cfg, checkpoint_path=args.checkpoint)
    if args.functionals_every:
        cfg = _dc.replace(cfg, functionals_every=args.functionals_every)
    if args.pipeline:
        cfg = _dc.replace(cfg,
                          main=_dc.replace(cfg.main, pipeline=True),
                          init=_dc.replace(cfg.init, pipeline=True))
    dtype = jnp.float32 if args.f32 else jnp.float64

    import os
    if not os.path.exists(cfg.mesh_file):
        print(f"fvens_tpu: mesh file not found: {cfg.mesh_file}",
              file=sys.stderr)
        return 1
    md = read_mesh(cfg.mesh_file)
    if args.mesh_reorder != "none":
        from ..mesh.ordering import apply_ordering
        md = apply_ordering(md, args.mesh_reorder,
                            anisotropy_threshold=(
                                args.mesh_anisotropy_threshold
                                if args.mesh_anisotropy_threshold is not None
                                else 10.0))
    mesh = compile_mesh(md, cfg.bcs, dtype=dtype)
    print(f"fvens_tpu: mesh {cfg.mesh_file}: {mesh.n_cells} cells, "
          f"{mesh.n_bfaces} boundary faces, {mesh.n_faces} faces")

    # live step monitor (+ streamed JSONL history if --history given):
    # SteadyStepMonitor / log_file_prefix parity (aodesolver.cpp:541-558)
    from ..io_config.logs import ConvergenceLogger
    logger = ConvergenceLogger(path=args.history,
                               print_every=args.log_every, label="main")
    t0 = time.perf_counter()
    try:
        if cfg.sim_type == "unsteady":
            # ctrl-driven physical-time run (reference casesolvers.cpp:
            # 424-444); writes the state at final_time
            from .casesolvers import UnsteadyFlowCase
            u, info, fnls = UnsteadyFlowCase(cfg).run_output(mesh)
            print(f"fvens_tpu: unsteady TVDRK{cfg.time_order} to "
                  f"t={cfg.final_time} in {info.steps} steps")
        elif args.devices:
            from .casesolvers import DistributedFlowCase
            dcase = DistributedFlowCase(cfg, n_devices=args.devices)
            u, info, fnls = dcase.run_output(md, log_every=args.log_every,
                                             logger=logger)
        else:
            case = SteadyFlowCase(cfg)
            u, info, fnls = case.run_output(mesh, log_every=args.log_every,
                                            logger=logger)
    finally:
        logger.close()
    wall = time.perf_counter() - t0

    print(f"fvens_tpu: solved in {info.steps} steps, "
          f"{info.total_lin_iters} linear iterations, {wall:.3f} s")
    print(f"  entropy error: {fnls.entropy:.10e}")
    print(f"  CL   = {fnls.CL:.15e}")
    print(f"  CDp  = {fnls.CDp:.15e}")
    print(f"  CDsf = {fnls.CDsf:.15e}")

    space = build_space(cfg)
    if args.surface and cfg.wall_markers:
        table, _ = surface_data(space, mesh, u, cfg.wall_markers)
        np.savetxt(args.surface, table, header="x y Cp Cf")
        print(f"  wrote surface data to {args.surface}")

    if args.volume:
        from ..output import volume_data
        np.savetxt(args.volume, volume_data(space, mesh, u),
                   header="x y rho vx vy p T mach")
        print(f"  wrote volume data to {args.volume}")

    if args.vtu:
        phy = space.phy
        un = np.asarray(u)[: mesh.n_cells]
        p = np.asarray(phy.pressure(jnp.asarray(un)))
        c = np.sqrt(cfg.physics.gamma * p / un[:, 0])
        vel = un[:, 1:3] / un[:, 0:1]
        mach = np.sqrt((vel ** 2).sum(1)) / c
        write_vtu(args.vtu, md,
                  cell_scalars={"density": un[:, 0], "pressure": p,
                                "mach": mach},
                  cell_vectors={"velocity": vel})
        print(f"  wrote VTU solution to {args.vtu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
