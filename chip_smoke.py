#!/usr/bin/env python3
"""Bring-up check: the solver's main path runs on the GPU and gives the
right answers.

    python chip_smoke.py           # one card: device, naca_laminar,
                                   #   cylinder_204k
    python chip_smoke.py --four    # the sharded path on four cards only

Phases (one process; each card is opened once):

  device        every JAX device is a GPU; prints the card's name and power
                limit (nvidia-smi), device_kind, the JAX version and whether
                the native C++ mesh kernels loaded.
  naca_laminar  the flagship viscous case (fvens_tpu/cases/flagship.py)
                through the CLI's main on the generated 12,800-cell NACA0012
                O-mesh; its CL/CDp/CDsf must lie within 1e-6 of the CPU
                float64 run committed in tests/data/naca_laminar_cpu.json.
  cylinder_204k the inviscid cylinder at 204.8k cells through SteadyFlowCase
                (banded, mixed precision, bsgs x6, FGMRES(90), blocked MGS):
                (a) the f64 residual matches the process's CPU device to
                rtol 1e-10, (b) the f32 banded matvec matches the f64
                gather matvec on the CPU to 1e-5, (b') the f32 einsum
                matvec and one bsgs x6 apply match the same f32 functions
                on the CPU to 1e-6 (full f32 products, not TF32), (c) the
                solve converges.
  four          (--four) the 204.8k cylinder partitioned over 4 GPUs: the
                state spans 4 distinct devices, the sharded f64 residual
                matches one card to rtol 1e-10, and the CLI's --devices 4
                naca_laminar run matches the one-card run to 1e-8.

Every gate that fails raises; nothing is caught. The last line of standard
output is the JSON result, printed only when every phase passed.
Meshes and case files are written under <checkout>/.smoke/.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SMOKE_DIR = os.path.join(ROOT, ".smoke")
NACA_REF = os.path.join(ROOT, "tests", "data", "naca_laminar_cpu.json")
FUNCTIONALS = ("CL", "CDp", "CDsf")

sys.path.insert(0, ROOT)


class GateError(AssertionError):
    """A bring-up gate did not hold."""


def gate(name: str, ok: bool, detail: str) -> None:
    print(f"  gate {name}: {'pass' if ok else 'FAIL'} ({detail})", flush=True)
    if not ok:
        raise GateError(f"{name}: {detail}")


def result_line(devices) -> str:
    """The final line: exactly {"ok", "device": {platform, kind, count}}."""
    return json.dumps({"ok": True,
                       "device": {"platform": devices[0].platform,
                                  "kind": devices[0].device_kind,
                                  "count": len(devices)}})


def phase_device(n_needed: int):
    """Every device is a GPU and there are at least n_needed of them."""
    import jax

    devices = jax.devices()
    platforms = sorted({d.platform for d in devices})
    if platforms != ["gpu"]:
        raise GateError(f"device: no GPU, JAX platforms {platforms}")
    if len(devices) < n_needed:
        raise GateError(f"device: {n_needed} GPUs needed, {len(devices)} "
                        "visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from fvens_tpu import native
    print(f"device: {' | '.join(smi.splitlines())}")
    print(f"device: {devices[0].device_kind} x{len(devices)}, jax "
          f"{jax.__version__}, native mesh kernels "
          f"{'loaded' if native.available() else 'not loaded (NumPy)'}",
          flush=True)
    return devices[:n_needed]


class _Tee(io.TextIOBase):
    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_cli(argv) -> dict:
    """cli.main(argv), echoing its output; returns steps, Krylov iterations,
    wall (host clock around main) and the printed functionals."""
    from fvens_tpu.cases import cli

    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    text = tee.buf.getvalue()
    if rc != 0:
        raise GateError(f"cli.main returned {rc}")
    m = re.search(r"solved in (\d+) steps, (\d+) linear iterations", text)
    out = {"steps": int(m.group(1)), "lin_iters": int(m.group(2)),
           "wall_s": wall}
    for k in FUNCTIONALS:
        out[k] = float(re.search(rf"\b{k}\s+=\s+(\S+)", text).group(1))
    return out


def naca_files(ref: dict):
    from fvens_tpu.cases.flagship import write_naca_laminar
    return write_naca_laminar(os.path.join(SMOKE_DIR, "naca"), **ref["case"])


def phase_naca(ref: dict) -> None:
    print("naca_laminar: CLI main, generated NACA0012 O-mesh", flush=True)
    ctrl, solverc = naca_files(ref)
    argv = [ctrl, "--options_file", solverc, "--log_every", "50"]
    cold = run_cli(argv)
    warm = run_cli(argv)
    print(f"naca_laminar: {warm['steps']} steps, {warm['lin_iters']} "
          f"Krylov iterations, cold wall {cold['wall_s']:.3f} s (with "
          f"compile), warm wall {warm['wall_s']:.3f} s")
    for k in FUNCTIONALS:
        d = abs(warm[k] - ref[k])
        gate(f"naca_laminar {k}", d <= 1e-6,
             f"{warm[k]:.12e} vs CPU f64 {ref[k]:.12e}, |diff| {d:.3e} "
             "<= 1e-6")


def _perturbed_state(space, mesh):
    """Free stream times a smooth positional perturbation (deterministic)."""
    import jax.numpy as jnp
    import numpy as np

    rc = np.asarray(mesh.rc)
    pert = 0.05 * np.sin(rc[:, 0]) * np.cos(rc[:, 1])
    return jnp.asarray(np.tile(np.asarray(space.uinf), (mesh.NC, 1))
                       * (1.0 + pert[:, None] * np.array([1.0, 0.5, -0.5,
                                                          1.0])))


def _rel_maxnorm(a, b) -> float:
    import numpy as np
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_cylinder(ni: int = 640, nj: int = 320) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fvens_tpu.cases.casesolvers import (SteadyFlowCase, build_space,
                                             initial_state)
    from fvens_tpu.cases.flagship import cylinder_config, cylinder_mesh
    from fvens_tpu.mesh import compile_mesh
    from fvens_tpu.solver import jacobian as jacmod
    from fvens_tpu.solver.banded import (banded_blocks, banded_structure,
                                         make_banded_matvec)
    from fvens_tpu.solver.linear import (BlockJacobian, bsr_matvec,
                                         make_preconditioner)

    cfg = cylinder_config()
    t0 = time.perf_counter()
    mesh = compile_mesh(cylinder_mesh(ni, nj), cfg.bcs, dtype=jnp.float64)
    n = mesh.n_cells
    print(f"cylinder_204k: {n} cells, set-up {time.perf_counter() - t0:.3f} s",
          flush=True)
    space = build_space(cfg)
    cpu = jax.devices("cpu")[0]
    mesh_c = jax.device_put(mesh, cpu)
    u = _perturbed_state(space, mesh)
    u_c = jax.device_put(u, cpu)

    # (a) f64 residual: GPU vs the same jitted function on the CPU device
    res = jax.jit(lambda m, u: space.compute_residual(m, u, True)[0])
    r_gpu = np.asarray(res(mesh, u))[:n]
    r_cpu = np.asarray(res(mesh_c, u_c))[:n]
    err = _rel_maxnorm(r_gpu, r_cpu)
    ew = float((np.abs(r_gpu - r_cpu)
                / np.maximum(np.abs(r_cpu), 1e-300)).max())
    gate("cylinder_204k residual f64 GPU vs CPU", err <= 1e-10,
         f"max-norm rel {err:.3e} <= 1e-10; elementwise max rel {ew:.3e}")

    # (b) the f32 banded matvec on the GPU vs the f64 gather matvec on the
    # CPU, both applying the same blocks (the mixed step's f32 Jacobian)
    # to the same vector
    def jac_of(m, u):
        _, dt = space.compute_residual(m, u, True)
        jac = space.assemble_jacobian(m, u)
        return jacmod.add_pseudotime_term(m, jac, 500.0, dt)

    bl = banded_structure(mesh)
    gate("cylinder_204k band-coverable", bl is not None,
         f"offsets {bl.offsets if bl is not None else None}")
    x32 = jax.random.normal(jax.random.PRNGKey(0), (mesh.NC, 4), jnp.float32)
    jac32 = jax.jit(jac_of)(mesh.astype(jnp.float32), u.astype(jnp.float32))
    mv = jax.jit(lambda D, N, x: make_banded_matvec(
        D, banded_blocks(bl, N), bl.offsets)(x))
    y32 = np.asarray(mv(jac32.D, jac32.N, x32))[:n].astype(np.float64)
    f64c = lambda a: jax.device_put(a, cpu).astype(jnp.float64)
    gather = jax.jit(bsr_matvec)
    y64 = np.asarray(gather(mesh_c, BlockJacobian(f64c(jac32.D),
                                                  f64c(jac32.N)),
                            f64c(x32)))[:n]
    err = _rel_maxnorm(y32, y64)
    gate("cylinder_204k banded matvec f32 GPU vs f64 CPU", err <= 1e-5,
         f"max-norm rel {err:.3e} <= 1e-5")
    # for the record, not a gate: the f32 Jacobian's own rounding, seen
    # through the matvec against the f64 Jacobian at the f64 state
    y_full = np.asarray(gather(mesh_c, jax.jit(jac_of)(mesh_c, u_c),
                               f64c(x32)))[:n]
    print(f"cylinder_204k: f32 Jacobian + matvec vs f64 Jacobian + matvec: "
          f"max-norm rel {_rel_maxnorm(y32, y_full):.3e}")

    # (b') the f32 dot_general path on the GPU vs the same jitted f32
    # function on the CPU: the slot-gather einsum matvec and one bsgs x6
    # apply (block inverse, D^-1 N einsum, six sweeps). Both pin HIGHEST
    # (solver/precision.py); TF32 products keep ~3 digits and would fail.
    pc_apply = jax.jit(lambda m, j, v: make_preconditioner(
        m, j, "bsgs", sweeps=6)(v))
    jac32_c, x32_c = jax.device_put((jac32, x32), cpu)
    reads = {}
    for name, fn in (("slot-gather einsum matvec", gather),
                     ("bsgs x6 apply", pc_apply)):
        reads[name] = _rel_maxnorm(np.asarray(fn(mesh, jac32, x32))[:n],
                                   np.asarray(fn(mesh_c, jac32_c, x32_c))[:n])
    # for the record, not a gate: the D-block product at DEFAULT precision
    loose = jax.jit(lambda D, x: jnp.einsum("cij,cj->ci", D, x))
    err = _rel_maxnorm(np.asarray(loose(jac32.D, x32))[:n],
                       np.asarray(loose(jac32_c.D, x32_c))[:n])
    print(f"cylinder_204k: f32 block product at DEFAULT precision, GPU vs "
          f"CPU: max-norm rel {err:.3e}")
    for name, err in reads.items():
        gate(f"cylinder_204k f32 {name} GPU vs CPU", err <= 1e-6,
             f"max-norm rel {err:.3e} <= 1e-6")
    del jac32, jac32_c, mesh_c, u_c

    # (c) starter + main solve, cold (with compile) and warm
    case = SteadyFlowCase(cfg)
    u0 = initial_state(space, mesh)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        uf, info = case.solve(mesh, u0, log_every=20)
        jax.block_until_ready(uf)
        walls.append(time.perf_counter() - t0)
    rel = info.finalres / info.initres
    its = [int(s[2]) for s in info.step_times]
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"cylinder_204k: main solve {info.steps} steps, "
          f"{info.total_lin_iters} Krylov iterations "
          f"({info.total_lin_iters / max(info.steps, 1):.1f} per step), "
          f"cold wall {walls[0]:.3f} s, warm wall {walls[1]:.3f} s "
          f"(starter included), peak device memory {peak} B")
    print(f"cylinder_204k: Krylov iterations per main step {its}")
    gate("cylinder_204k solve converged",
         info.converged and info.steps <= 200
         and (rel <= 1e-6 or info.finalres <= 1e-10),
         f"{info.steps} steps <= 200, rel {rel:.3e}, abs "
         f"{info.finalres:.3e}")


def phase_four(devices, ref: dict, ni: int = 640, nj: int = 320) -> None:
    """The sharded path across `devices` (4 cards) against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fvens_tpu.cases.casesolvers import build_space
    from fvens_tpu.cases.flagship import cylinder_config, cylinder_mesh
    from fvens_tpu.dist import ShardedFlow, partition_mesh
    from fvens_tpu.mesh import compile_mesh

    nd = len(devices)
    cfg = cylinder_config()
    md = cylinder_mesh(ni, nj)
    space = build_space(cfg)
    t0 = time.perf_counter()
    bundle = partition_mesh(md, cfg.bcs, nd)
    print(f"four: {md.nelem} cells partitioned over {nd} devices in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    sf = ShardedFlow(space=space, bundle=bundle, devices=list(devices))

    mesh = compile_mesh(md, cfg.bcs, dtype=jnp.float64)
    u = _perturbed_state(space, mesh)
    r_one = np.asarray(jax.jit(
        lambda m, u: space.compute_residual(m, u, True)[0])(
            jax.device_put(mesh, devices[0]),
            jax.device_put(u, devices[0])))[:mesh.n_cells]

    gid = np.asarray(bundle.own_gid)
    u_np = np.asarray(u)
    u_loc = np.tile(np.asarray(space.uinf), (nd, bundle.mesh.NC, 1))
    for p in range(nd):
        k = int(bundle.own_counts[p])
        u_loc[p, :k] = u_np[gid[p, :k]]
    u_sh = jax.device_put(jnp.asarray(u_loc), sf.initial_state().sharding)
    held = {s.device for s in u_sh.addressable_shards}
    gate("four state sharding", held == set(devices) and len(held) == nd,
         f"{len(held)} distinct devices: "
         + ", ".join(sorted(str(d) for d in held)))
    rhs_sh, _ = jax.jit(sf.residual)(u_sh)
    r_sh = sf.gather_solution(rhs_sh)
    err = _rel_maxnorm(r_sh, r_one)
    gate("four sharded residual vs one card", err <= 1e-10,
         f"max-norm rel {err:.3e} <= 1e-10")

    ctrl, solverc = naca_files(ref)
    base = [ctrl, "--options_file", solverc, "--log_every", "50"]
    one = run_cli(base)
    many = run_cli(base + ["--devices", str(nd)])
    print(f"four: naca_laminar one card {one['steps']} steps / "
          f"{one['lin_iters']} Krylov iterations / {one['wall_s']:.3f} s; "
          f"{nd} cards {many['steps']} steps / {many['lin_iters']} Krylov "
          f"iterations / {many['wall_s']:.3f} s (both with compile)")
    for k in FUNCTIONALS:
        d = abs(many[k] - one[k])
        gate(f"four naca_laminar {k}", d <= 1e-8,
             f"{nd} cards {many[k]:.12e} vs one card {one[k]:.12e}, "
             f"|diff| {d:.3e} <= 1e-8")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path, on four GPUs")
    args = ap.parse_args(argv)

    # the CPU device stays available next to the GPU: gates (a) and (b)
    # compare against it inside this one process
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    devices = phase_device(4 if args.four else 1)
    from fvens_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    with open(NACA_REF) as f:
        ref = json.load(f)
    if args.four:
        phase_four(devices, ref)
    else:
        phase_naca(ref)
        phase_cylinder()
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
