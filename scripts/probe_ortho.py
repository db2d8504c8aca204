"""Pinpoint where the GMRES basis (ortho) time goes at large n.

Times MINIMAL while_loop bodies that each isolate one mechanism, on the
same (mpad, n) shapes as the blocked-MGS path of solver/linear.py:

  append   V.at[j+1].set(w) only              -> carry/copy cost of the append
  read     one blocked-MGS pass, no append    -> pure basis-read cost
  mgs      read + append (the real body core) -> interaction
  cgs      dense masked V@w + V.T@h (classic) -> the small-n path

If XLA updates the loop-carried basis in place, one append moves O(n)
bytes (the row written, w read); if it copies the basis, O(mpad * n).
`append_row_bytes_ms` and `basis_copy_ms` are those two streaming bounds
at the measured copy bandwidth. With --trace DIR the append loop also
runs under jax.profiler and the device kernels it launched are listed
with their total time and count.

Usage: python scripts/probe_ortho.py --cells 819200 [--m 90] [--trace DIR]
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def trace_kernels(f, arg, outdir, top=8):
    """Run f(arg) once under jax.profiler; return the device kernels it ran
    as [{name, count, total_us}], largest total first."""
    import glob

    import jax

    jax.block_until_ready(f(arg))
    with jax.profiler.trace(outdir):
        jax.block_until_ready(f(arg))
    path = sorted(glob.glob(os.path.join(outdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    from jax.profiler import ProfileData
    agg = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                c, t = agg.get(ev.name, (0, 0.0))
                agg[ev.name] = (c + 1, t + ev.duration_ns / 1e3)
    rows = [{"name": k, "count": c, "total_us": t}
            for k, (c, t) in agg.items()]
    return sorted(rows, key=lambda r: -r["total_us"])[:top]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=819200)
    ap.add_argument("--m", type=int, default=90)
    ap.add_argument("--iters", type=int, default=45,
                    help="loop iterations per timed run (the filled-row "
                         "count grows 1..iters, like a real cycle)")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--trace", default=None,
                    help="profile the append loop into this directory")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)
    from fvens_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from fvens_tpu.solver.linear import _mgs_pass, _ROW_BLOCK
    from fvens_tpu.solver.precision import matmul

    n = args.cells * 4
    m = args.m
    mpad = -(-(m + 1) // _ROW_BLOCK) * _ROW_BLOCK
    dtype = jnp.float32
    ar = lambda x: x

    key = jax.random.PRNGKey(0)
    w0 = jax.random.normal(key, (n,), dtype)

    def run_loop(body):
        def f(w):
            V = jnp.zeros((mpad, n), dtype).at[0].set(w / jnp.linalg.norm(w))

            def cond(c):
                return c[2] < args.iters

            def wrapped(c):
                V, w, j = c
                V, w = body(V, w, j)
                # force a genuine per-iteration data dependency on the
                # updated basis: without this read XLA elided the whole
                # append chain (first runs timed 0.002 ms/iter — a
                # physically impossible number at (96, 3.28M))
                w = w + 1e-30 * V[(j * 7 + 3) % mpad]
                return (V, w, j + 1)

            V, w, j = jax.lax.while_loop(cond, wrapped, (V, w, 0))
            # consume ALL of V: returning a single row lets XLA dead-code
            # eliminate every other row's append (measured: the loop
            # collapsed to one write and timed 0.003 ms/iter)
            return V.sum() + w.sum()
        return jax.jit(f)

    def body_append(V, w, j):
        return V.at[j + 1].set(w), w * 0.999

    def body_read(V, w, j):
        h, w2 = _mgs_pass(V, w, j + 1, ar)
        return V, w2 + 1e-20 * h[0]

    def body_mgs(V, w, j):
        h, w2 = _mgs_pass(V, w, j + 1, ar)
        hn = jnp.sqrt(jnp.sum(w2 * w2))
        return V.at[j + 1].set(w2 / jnp.maximum(hn, 1e-30)), w2

    def body_cgs(V, w, j):
        mask = (jnp.arange(mpad) <= j).astype(dtype)
        h = matmul(V, w) * mask
        w2 = w - matmul(V.T, h)
        hn = jnp.sqrt(jnp.sum(w2 * w2))
        return V.at[j + 1].set(w2 / jnp.maximum(hn, 1e-30)), w2

    out = {"cells": args.cells, "n": n, "m": m, "iters": args.iters}
    # streaming bounds at the measured device copy bandwidth
    big = jnp.ones((mpad, n), dtype)
    cp = jax.jit(lambda x: x * 1.0001)
    jax.block_until_ready(cp(big))
    t0 = time.perf_counter()
    for _ in range(5):
        y = cp(big)
    jax.block_until_ready(y)
    del y
    bw = 2 * big.nbytes * 5 / (time.perf_counter() - t0)
    del big
    out["copy_GBps"] = bw / 1e9
    out["append_row_bytes_ms"] = 2 * n * 4 / bw * 1e3
    out["basis_copy_ms"] = 2 * mpad * n * 4 / bw * 1e3
    print(f"# copy {bw / 1e9:.1f} GB/s: one row append moves >= "
          f"{out['append_row_bytes_ms']:.4f} ms of bytes, a basis copy "
          f"{out['basis_copy_ms']:.4f} ms", flush=True)

    variants = [("append", body_append), ("read", body_read),
                ("mgs", body_mgs), ("cgs", body_cgs)]
    for name, body in variants:
        f = run_loop(body)
        jax.block_until_ready(f(w0))            # compile
        t0 = time.perf_counter()
        jax.block_until_ready(f(w0))
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        out[f"{name}_ms_per_iter"] = ms
        print(f"# {name}: {ms:.4f} ms/iter", flush=True)
    if args.trace:
        out["append_kernels"] = trace_kernels(run_loop(body_append), w0,
                                              args.trace)
        for k in out["append_kernels"]:
            print(f"# append trace: {k}", flush=True)
    out["platform"] = jax.devices()[0].platform
    out["device_kind"] = jax.devices()[0].device_kind
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
