"""Device-native linear solver stack: face-block sparse Jacobian operators,
block preconditioners and a restarted (F)GMRES.

Replaces PETSc (MPIBAIJ + FGMRES(30) + bjacobi/ILU0, FVENS
src/linalg/alinalg.cpp + testcases/defaults.solverc) with batched,
gather-and-contract primitives:

  - the Jacobian is stored as face blocks (A = len dF/du_left,
    B = len dF/du_right per face) plus cell diagonal blocks, i.e. exactly the
    4x4-block sparsity of the reference's BAIJ matrix;
  - the matvec is a per-cell incidence gather + batched 4x4 contractions;
  - Arnoldi orthogonalization is a (m+1, N) x (N,) matrix-vector product.

Every float32 product goes through solver/precision.py (HIGHEST), so the
Krylov numerics do not depend on the device's default matmul precision.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .precision import dot, einsum, matmul


class BlockJacobian(NamedTuple):
    """First-order Jacobian of r(u) = -rhs(u) in per-cell-slot block form
    (the layout the matvec and the SGS sweeps consume directly):

        (J x)_c = D_c x_c + sum_k N_ck x_nbr(c,k)

    D folds the boundary-ghost contribution (the reference's
    `left = len*(L - R*drdl)` fold, flow_spatial.cpp:841-875, comes free
    from differentiating through the BC composition in assemble_jacobian).
    """
    D: jnp.ndarray   # (NC,V,V) diagonal blocks (incl. pseudo-time term)
    N: jnp.ndarray   # (NC,4,V,V) per-slot neighbour blocks (0 at boundaries)


def _nbrs_in_range(mesh):
    """Neighbour indices clamped into [0, NC): boundary/ghost slots point at
    an arbitrary real row, which is safe wherever the gathered value is
    multiplied by the neighbour blocks N (zero on exactly those slots,
    solver/jacobian.py:86). Avoids the per-matvec pad-concatenate of the
    ghost rows; the jnp.minimum of a closed-over constant folds at compile
    time under jit."""
    return jnp.minimum(mesh.cell_nbrs, mesh.NC - 1)


def make_bsr_matvec(mesh, jac: BlockJacobian) -> Callable:
    """Returns mv(x) = J x as two device ops (one (NC,5) row gather + one
    batched block einsum): the diagonal joins the neighbour slots as a fifth
    self-pointing slot, so the whole BSR matvec is a single fused
    contraction. The fused (NC,5,V,V) operand is built here,
    ONCE per Jacobian — call this outside the Krylov loop."""
    NC = jac.D.shape[0]
    self_idx = jnp.arange(NC, dtype=mesh.cell_nbrs.dtype)
    idx = jnp.concatenate([self_idx[:, None], _nbrs_in_range(mesh)], axis=1)
    blocks = jnp.concatenate([jac.D[:, None], jac.N], axis=1)   # (NC,5,V,V)

    def mv(x):
        return einsum("ckij,ckj->ci", blocks, x[idx])

    return mv


def bsr_matvec(mesh, jac: BlockJacobian, x):
    """y = J x with the slot-block Jacobian; x (NC,V)."""
    return make_bsr_matvec(mesh, jac)(x)


def block_jacobi_inverse(D):
    """Batched small-matrix inverses for the block-Jacobi preconditioner.

    Closed-form adjugate (n <= 4) rather than jnp.linalg.inv: unrolled
    cofactors are plain elementwise arithmetic that fuses into one loop
    over the cells, with no batched-LU library call per Newton step.
    """
    n = D.shape[-1]
    if n == 1:
        return 1.0 / D
    if n == 2:
        a, b = D[..., 0, 0], D[..., 0, 1]
        c, d = D[..., 1, 0], D[..., 1, 1]
        det = a * d - b * c
        inv = jnp.stack([jnp.stack([d, -b], -1), jnp.stack([-c, a], -1)], -2)
        return inv / det[..., None, None]
    if n == 4:
        return _inv4(D)
    raise NotImplementedError(f"block size {n}")


def _inv4(M):
    """Batched explicit 4x4 inverse by cofactor expansion."""
    m = [[M[..., i, j] for j in range(4)] for i in range(4)]

    def det3(r, c):
        rows = [i for i in range(4) if i != r]
        cols = [j for j in range(4) if j != c]
        a, b, cc = rows
        p, q, s = cols
        return (m[a][p] * (m[b][q] * m[cc][s] - m[b][s] * m[cc][q])
                - m[a][q] * (m[b][p] * m[cc][s] - m[b][s] * m[cc][p])
                + m[a][s] * (m[b][p] * m[cc][q] - m[b][q] * m[cc][p]))

    cof = [[((-1.0) ** (i + j)) * det3(i, j) for j in range(4)]
           for i in range(4)]
    det = sum(m[0][j] * cof[0][j] for j in range(4))
    # adjugate = transpose of cofactor matrix
    adj = jnp.stack([jnp.stack([cof[j][i] for j in range(4)], axis=-1)
                     for i in range(4)], axis=-2)
    return adj / det[..., None, None]


def make_preconditioner(mesh, jac: BlockJacobian, kind: str = "bjacobi",
                        sweeps: int = 4, lines=None, mg=None,
                        mg_opts=None, ilu=None, ilu_setup: int = 4
                        ) -> Callable:
    """Returns pc(v) ~= J^-1 v.

    bjacobi: z = D^-1 v (the reference default bjacobi+ILU0 analogue at
    block granularity).
    bsgs: `sweeps` damped block-Jacobi fixed-point iterations
    z_{k+1} = z_k + D^-1 (v - J z_k) — the async-sweep idea of BLASTed
    (perftest/) in its Jacobi form, which needs no sequential ordering.
    """
    if kind == "none":
        return lambda v: v
    Dinv = block_jacobi_inverse(jac.D)
    apply_dinv = lambda v: einsum("cij,cj->ci", Dinv, v)
    if kind == "bjacobi":
        return apply_dinv
    if kind == "bsgs":
        # the defect-correction sweep z + D^-1(v - J z) reduces exactly to
        # block-Jacobi z' = D^-1 v - (D^-1 N) z_nbr (J = D + N), so one sweep
        # is a single 4-slot neighbour gather + one batched einsum — the
        # cheapest-per-sweep smoother shape (no scatters, no colors)
        DN = einsum("cij,ckjl->ckil", Dinv, jac.N)
        nbrs = _nbrs_in_range(mesh)

        def pc(v):
            dv = apply_dinv(v)
            z = dv
            for _ in range(sweeps):
                z = dv - einsum("ckij,ckj->ci", DN, z[nbrs])
            return z
        return pc
    if kind == "bcsgs":
        return make_colored_sgs(mesh, jac, Dinv, jac.N, sweeps)
    if kind == "ilu0":
        # Chow-Patel fixed-point block ILU(0) — the parallel form of the
        # reference's BLASTed async-ILU default (defaults.solverc:16-19);
        # see solver/ilu.py
        if ilu is None:
            raise ValueError("pc='ilu0' needs an ILUStructure")
        from .ilu import ilu_factorize, make_ilu_apply
        L, Ud, Udinv, Us = ilu_factorize(mesh, jac, ilu, sweeps=ilu_setup)
        return make_ilu_apply(mesh, L, Udinv, Us, sweeps=sweeps)
    if kind == "bline":
        if lines is None:
            raise ValueError("pc='bline' needs a LineStructure")
        return make_line_smoother(mesh, jac, lines, sweeps)
    if kind == "amg":
        if mg is None:
            raise ValueError("pc='amg' needs an MGHierarchy")
        from .multigrid import make_mg_preconditioner
        return make_mg_preconditioner(mesh, jac, mg, **(mg_opts or {}))
    raise ValueError(f"unknown preconditioner '{kind}'")


def make_line_smoother(mesh, jac: BlockJacobian, lines, sweeps: int = 1):
    """Line-implicit block smoother: exact block-tridiagonal solves along
    strong-coupling lines (batched Thomas), with off-line coupling lagged
    Jacobi-style between sweeps. The batched counterpart of line-implicit /
    DDADI smoothers for boundary-layer stiffness.
    """
    nv = jac.D.shape[-1]
    NC = jac.D.shape[0]
    dt = jac.D.dtype   # masks are built f64; cast so f32 (mixed-precision)
    lc = lines.line_cells                     # Jacobians are not promoted
    line_mask = lines.line_mask.astype(dt)

    # per-line tridiagonal blocks, gathered once per Newton step
    bdiag = jac.D[lc]                                        # (NL,L,V,V)
    a = jac.N[lc, lines.dn_slot] * lines.dn_valid[..., None, None].astype(dt)
    c = jac.N[lc, lines.up_slot] * lines.up_valid[..., None, None].astype(dt)

    # off-line neighbour blocks (everything not on the line's tridiagonal);
    # boundary slots of N are zero, so clamped in-range gathers are safe
    N_off = jac.N * (1.0 - lines.line_slot_mask).astype(dt)[..., None, None]
    nbrs_in = _nbrs_in_range(mesh)

    def offdiag_off(z):
        return einsum("ckij,ckj->ci", N_off, z[nbrs_in])

    from .lines import block_thomas

    # scatter helper safe against padded duplicate indices
    scatter_idx = jnp.where(lines.line_mask > 0, lc, NC)

    def pc(v):
        z = jnp.zeros_like(v)
        for _ in range(sweeps):
            r = v - offdiag_off(z)
            d = r[lc] * line_mask[..., None]                 # (NL,L,V)
            x = block_thomas(a, bdiag, c, d)
            zfull = jnp.zeros((NC + 1, nv), v.dtype)
            zfull = zfull.at[scatter_idx].set(x)
            z = zfull[:NC]
        return z

    return pc


def make_colored_sgs(mesh, jac: BlockJacobian, Dinv, blocks,
                     sweeps: int = 1):
    """Multicolor block symmetric Gauss-Seidel.

    The data-parallel form of the reference's bjacobi+ILU0 / BLASTed SGS sweeps
    (testcases/defaults.solverc, perftest/): cells of one adjacency color
    share no faces, so each color updates as one batched 4x4 solve with the
    freshest neighbour values. One sweep = forward + backward color passes.

    All gathered structures (per-color D^-1-folded off-diagonal tensors) are
    precomputed once per Newton step and closed over, so one color update is
    just THREE device ops: a (R,4) row gather of z, one batched einsum, and
    the row scatter. D^-1 is folded into the neighbour blocks
    (z_c = (D^-1 v)_c - sum_k (D^-1 N)_ck z_nbr), removing the per-update
    triangular-ish solve, and neighbour indices are clamped in-range
    (boundary slots multiply zero blocks) so no ghost padding is ever built.
    """
    rows_all = mesh.color_rows                       # (ncol, R)
    ncol = mesh.n_colors
    nbrs_in = _nbrs_in_range(mesh)

    # static per-color gathers + Dinv folding, done once per Newton step
    col_nbrs = [nbrs_in[rows_all[c]] for c in range(ncol)]
    col_DN = [einsum("rij,rkjl->rkil", Dinv[rows_all[c]],
                         blocks[rows_all[c]]) for c in range(ncol)]

    def pc(v):
        dv = einsum("cij,cj->ci", Dinv, v)       # one whole-mesh solve
        col_dv = [dv[rows_all[c]] for c in range(ncol)]

        def color_update(z, c):
            zn = z[col_nbrs[c]]                      # (R,4,nv)
            znew = col_dv[c] - einsum("rkij,rkj->ri", col_DN[c], zn)
            return z.at[rows_all[c]].set(znew)

        z = jnp.zeros_like(v)
        for _ in range(sweeps):
            for c in range(ncol):                    # forward
                z = color_update(z, c)
            for c in range(ncol - 1, -1, -1):        # backward
                z = color_update(z, c)
        return z

    return pc


# auto-switch: above this many local vector elements the gmres basis work
# runs the blocked-MGS low-traffic path (see gmres docstring); below it the
# classic CGS2 path is kept bit-identical (it protects the small-mesh
# regression trajectories, and at small n the blocked loop's serialized
# row-block products cost more dispatch than they save in basis reads)
_BLOCKED_N_THRESHOLD = 262_144
_ROW_BLOCK = 8           # basis rows per blocked-MGS product


def _mgs_pass(V, w, rows, ar):
    """One blocked modified-Gram-Schmidt pass of w against V[:rows].

    Reads only ceil(rows/8)*8 basis rows (rows is traced; the classic CGS2
    passes read all m+1 rows through a zero mask — at FGMRES(90) that is
    ~2x the traffic actually needed, and the basis reads dominate the
    per-iteration cost at >=200k cells).
    Each 8-row block is projected out of w before the next block is read
    (block-MGS), which is numerically at least as strong as one classical
    pass. Rows beyond `rows`-1 are still zero in V, so the rounded-up tail
    projects nothing. Returns (h, w_new) with h zero beyond rows-1."""
    B = _ROW_BLOCK
    mpad, n = V.shape
    nblk = (rows + B - 1) // B

    def blk(i, carry):
        h, wv = carry
        Vb = jax.lax.dynamic_slice(V, (i * B, 0), (B, n))
        hb = ar(matmul(Vb, wv))
        wv = wv - matmul(hb, Vb)
        return jax.lax.dynamic_update_slice(h, hb, (i * B,)), wv

    h0 = jnp.zeros((mpad,), w.dtype)
    return jax.lax.fori_loop(0, nblk, blk, (h0, w))


def _rows_combine(M, y, rows):
    """x-update helper: M[:rows].T @ y reading only the used row blocks."""
    B = _ROW_BLOCK
    n = M.shape[1]
    nblk = (rows + B - 1) // B

    def blk(i, acc):
        Mb = jax.lax.dynamic_slice(M, (i * B, 0), (B, n))
        yb = jax.lax.dynamic_slice(y, (i * B,), (B,))
        return acc + matmul(yb, Mb)

    return jax.lax.fori_loop(0, nblk, blk, jnp.zeros(n, M.dtype))


def gmres(matvec: Callable, b, x0, pc: Callable, restart: int = 30,
          maxiter: int = 30, rtol: float = 1e-1, allreduce: Callable = None,
          axis_name: str = None, blocked: bool = None):
    """Right-preconditioned restarted GMRES on (NC,V)-shaped vectors.

    Matches the reference's default Krylov settings (FGMRES(30), rtol 1e-1,
    testcases/defaults.solverc:12-15). Returns (x, iterations, relres).
    The flexible (FGMRES) storage of preconditioned directions Z is kept so
    iteration-dependent preconditioners remain legal.

    `allreduce` (e.g. partial(jax.lax.psum, axis_name=...)) is applied to
    every inner-product partial sum, making the same code run distributed
    under shard_map with each rank holding its slab of the vectors.

    `blocked` (None = auto by problem size): the large-n basis path —
    blocked-MGS orthogonalization reading only the filled basis rows, ONE
    pass with a selective second pass (run only when the norm drops below
    0.7x, the classic Rutishauser/Kahan criterion, via lax.cond), and NO
    stored Z: every preconditioner in this module is a fixed linear
    operator per Newton step, so x = x0 + M^-1 (V y) needs one trailing pc
    apply instead of an (m, n) direction store. Cuts the dominant
    per-iteration basis traffic ~4x and halves Krylov memory; the classic
    path stays bit-identical for small cases and distributed runs.
    """
    shape = b.shape
    dtype = b.dtype
    n = b.size
    bf = b.reshape(n)
    if blocked is None:
        blocked = n >= _BLOCKED_N_THRESHOLD and axis_name is None
    if axis_name is not None and allreduce is None:
        allreduce = lambda x: jax.lax.psum(x, axis_name)
    ar = allreduce if allreduce is not None else (lambda x: x)
    # under shard_map, locally-created basis arrays must be marked as
    # device-varying before entering the while_loop carry
    pv = ((lambda x: jax.lax.pcast(x, axis_name, to="varying"))
          if axis_name else (lambda x: x))

    mv = lambda v: matvec(v.reshape(shape)).reshape(n)
    pcf = lambda v: pc(v.reshape(shape)).reshape(n)

    bnorm = jnp.sqrt(ar(jnp.sum(bf * bf)))
    tol = rtol * bnorm
    m = restart
    ncycles = max(1, -(-maxiter // restart))

    def cycle(x, total_iters):
        r = bf - mv(x)
        beta = jnp.sqrt(ar(jnp.sum(r * r)))

        V = pv(jnp.zeros((m + 1, n), dtype))
        Z = pv(jnp.zeros((m, n), dtype))
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)
        V = V.at[0].set(r / jnp.maximum(beta, 1e-300))

        def cond(carry):
            V, Z, H, cs, sn, g, j, res = carry
            return (j < m) & (res > tol)

        def body(carry):
            V, Z, H, cs, sn, g, j, _ = carry
            z = pcf(V[j])
            w = mv(z)
            Z = Z.at[j].set(z)

            # classical Gram-Schmidt as two dense passes (CGS2)
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            h = ar(matmul(V, w)) * mask
            w = w - matmul(V.T, h)
            h2 = ar(matmul(V, w)) * mask   # one re-orthogonalization pass
            w = w - matmul(V.T, h2)
            h = h + h2
            hn = jnp.sqrt(ar(jnp.sum(w * w)))
            V = V.at[j + 1].set(w / jnp.maximum(hn, 1e-300))
            hcol = h.at[j + 1].set(hn)

            # apply stored Givens rotations to the new column
            def rot(i, hc):
                t1 = cs[i] * hc[i] + sn[i] * hc[i + 1]
                t2 = -sn[i] * hc[i] + cs[i] * hc[i + 1]
                return hc.at[i].set(t1).at[i + 1].set(t2)
            hcol = jax.lax.fori_loop(0, j, rot, hcol)

            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c_new = hcol[j] / jnp.maximum(denom, 1e-300)
            s_new = hcol[j + 1] / jnp.maximum(denom, 1e-300)
            hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            g_new = g.at[j + 1].set(-s_new * g[j]).at[j].set(c_new * g[j])

            H = H.at[:, j].set(hcol)
            res = jnp.abs(g_new[j + 1])
            return (V, Z, H, cs, sn, g_new, j + 1, res)

        carry = (V, Z, H, cs, sn, g, jnp.array(0), beta)
        V, Z, H, cs, sn, g, j, res = jax.lax.while_loop(cond, body, carry)

        # solve the (masked) upper-triangular system H[:j,:j] y = g[:j]
        used = jnp.arange(m) < j
        R = H[:m, :m] * used[None, :] * used[:, None]
        R = R + jnp.diag(jnp.where(used, 0.0, 1.0))
        rhs_t = jnp.where(used, g[:m], 0.0)

        # explicit back-substitution on the small (m, m) Hessenberg system
        def back(i, y):
            k = m - 1 - i
            yk = (rhs_t[k] - dot(R[k], y)) / R[k, k]
            return y.at[k].set(yk)
        y = jax.lax.fori_loop(0, m, back, jnp.zeros(m, dtype))
        x = x + matmul(Z.T, y)
        return x, total_iters + j, res

    mpad = -(-(m + 1) // _ROW_BLOCK) * _ROW_BLOCK

    def cycle_blocked(x, total_iters):
        # large-n cycle: same Arnoldi/Givens algebra as `cycle`, with
        # (a) blocked-MGS reading only the filled basis rows, (b) a
        # SELECTIVE second orthogonalization pass (skipped at runtime
        # unless the projection removed >30% of w's norm), and (c) no Z
        # store — the pc is applied once to the combined direction V y
        # (legal for the fixed linear preconditioners this module builds)
        r = bf - mv(x)
        beta = jnp.sqrt(ar(jnp.sum(r * r)))

        V = jnp.zeros((mpad, n), dtype)
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)
        V = V.at[0].set(r / jnp.maximum(beta, 1e-300))

        def cond(carry):
            V, H, cs, sn, g, j, res = carry
            return (j < m) & (res > tol)

        def body(carry):
            V, H, cs, sn, g, j, _ = carry
            w = mv(pcf(V[j]))

            wn0 = jnp.sqrt(ar(jnp.sum(w * w)))
            h, w = _mgs_pass(V, w, j + 1, ar)
            wn1 = jnp.sqrt(ar(jnp.sum(w * w)))
            h2, w = jax.lax.cond(
                wn1 < 0.7 * wn0,
                lambda wv: _mgs_pass(V, wv, j + 1, ar),
                lambda wv: (jnp.zeros((mpad,), dtype), wv),
                w)
            h = h + h2
            hn = jnp.sqrt(ar(jnp.sum(w * w)))
            V = V.at[j + 1].set(w / jnp.maximum(hn, 1e-300))
            hcol = h[:m + 1].at[j + 1].set(hn)

            def rot(i, hc):
                t1 = cs[i] * hc[i] + sn[i] * hc[i + 1]
                t2 = -sn[i] * hc[i] + cs[i] * hc[i + 1]
                return hc.at[i].set(t1).at[i + 1].set(t2)
            hcol = jax.lax.fori_loop(0, j, rot, hcol)

            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c_new = hcol[j] / jnp.maximum(denom, 1e-300)
            s_new = hcol[j + 1] / jnp.maximum(denom, 1e-300)
            hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            g_new = g.at[j + 1].set(-s_new * g[j]).at[j].set(c_new * g[j])

            H = H.at[:, j].set(hcol)
            res = jnp.abs(g_new[j + 1])
            return (V, H, cs, sn, g_new, j + 1, res)

        carry = (V, H, cs, sn, g, jnp.array(0), beta)
        V, H, cs, sn, g, j, res = jax.lax.while_loop(cond, body, carry)

        used = jnp.arange(m) < j
        R = H[:m, :m] * used[None, :] * used[:, None]
        R = R + jnp.diag(jnp.where(used, 0.0, 1.0))
        rhs_t = jnp.where(used, g[:m], 0.0)

        def back(i, y):
            k = m - 1 - i
            yk = (rhs_t[k] - dot(R[k], y)) / R[k, k]
            return y.at[k].set(yk)
        y = jax.lax.fori_loop(0, m, back, jnp.zeros(m, dtype))
        ypad = jnp.zeros(mpad, dtype).at[:m].set(y)
        x = x + pcf(_rows_combine(V, ypad, j))
        return x, total_iters + j, res

    run_cycle = cycle_blocked if blocked else cycle
    x = x0.reshape(n)
    iters = jnp.array(0)
    res = jnp.array(jnp.inf, dtype)
    for c in range(ncycles):
        if c == 0:
            x, iters, res = run_cycle(x, iters)
        else:
            # early exit: converged restarts skip the whole cycle (incl.
            # its residual-recompute matvec) at runtime via lax.cond
            x, iters, res = jax.lax.cond(
                res > tol,
                lambda carry: run_cycle(carry[0], carry[1]),
                lambda carry: carry,
                (x, iters, res))
    return x.reshape(shape), iters, res / jnp.maximum(bnorm, 1e-300)


def gmres_dr(matvec: Callable, b, x0, pc: Callable, U=None, k: int = 16,
             restart: int = 30, maxiter: int = 30, rtol: float = 1e-1,
             allreduce: Callable = None, axis_name: str = None):
    """Deflated/recycling right-preconditioned GMRES (GCRO-DR class).

    The reference reaches few Krylov iterations per Newton step through a
    sequential ILU0 (testcases/defaults.solverc:16-19); sequential sweeps
    are latency-bound on a data-parallel device, so the route taken here to
    the same goal is SUBSPACE RECYCLING: carry k approximate slow
    directions of the (slowly varying) Jacobian across Newton steps and
    deflate them from every solve. All added work is tall-skinny dense
    algebra (C@w projections, one QR, one small SVD).

    Scheme (GCRO with SVD harvest — Parks et al. GCRO-DR, with the small
    harmonic-Ritz eigenproblem replaced by an SVD of the exact relation
    A [U;Z] = [C;V] G, since XLA has no nonsymmetric eig on accelerators):
      setup    C R = qr(A U),  U <- R^-T U       (so A U = C, C orthonormal)
      init     x += U^T (C r0), r -= C^T (C r0)
      Arnoldi  on (I - C^T C) A M^-1, storing B = C A Z
      update   x += Z^T y - U^T (B y)            (residual-optimal over
                                                  span(U) + span(Z))
      harvest  k smallest right singular vectors of G = [[I,B],[0,Hbar]]
               -> U' = Y^T [U;Z]

    U: (k,)+b.shape recycled directions from the previous solve, or None
    (first call: plain projected Arnoldi, harvest only).
    Returns (x, iters, relres, U_new) with U_new shaped like U.

    `allreduce`/`axis_name`: same contract as gmres — with an axis, every
    inner product is psum'd and each rank holds its slab of the vectors, so
    the same code runs distributed under shard_map. The two tall-skinny QRs
    (setup A U^T = Q R and the harvest orthonormalization) become
    Cholesky-QR with a psum'd k x k Gram matrix: G = (A U)(A U)^T = R^T R,
    so C = L^-1 (A U) and U <- L^-1 U with L = chol(G) — identical algebra,
    axis-local except for the small replicated Gram psum.
    """
    shape = b.shape
    dtype = b.dtype
    n = b.size
    bf = b.reshape(n)
    if axis_name is not None and allreduce is None:
        allreduce = lambda x: jax.lax.psum(x, axis_name)
    ar = allreduce if allreduce is not None else (lambda x: x)
    pv = ((lambda x: jax.lax.pcast(x, axis_name, to="varying"))
          if axis_name else (lambda x: x))
    mv = lambda v: matvec(v.reshape(shape)).reshape(n)
    pcf = lambda v: pc(v.reshape(shape)).reshape(n)

    def cholqr(A):
        """Rows of A -> L^-1 A with orthonormal rows (Cholesky QR over the
        device axis); returns (Q_rows, L). The jittered Gram diagonal plays
        the rank-deficiency role of the QR path's R-diag clamping."""
        G = ar(matmul(A, A.T))
        eps = (jnp.asarray(1e-12, dtype) * jnp.trace(G) / max(k, 1)
               + jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-37,
                             dtype))
        L = jnp.linalg.cholesky(G + eps * jnp.eye(k, dtype=dtype))
        L = jnp.where(jnp.isfinite(L), L, jnp.eye(k, dtype=dtype))
        return jax.scipy.linalg.solve_triangular(L, A, lower=True), L

    bnorm = jnp.sqrt(ar(jnp.sum(bf * bf)))
    tol = rtol * bnorm
    m = restart
    ncycles = max(1, -(-maxiter // restart))
    have_U = U is not None

    if have_U:
        Ur = U.reshape(k, n).astype(dtype)
        if axis_name is None:
            AU = jax.vmap(mv)(Ur)                   # (k, n) batched matvec
            Q, R = jnp.linalg.qr(AU.T)              # A U^T = Q R
            # guard a rank-deficient recycle space: clamp tiny R diagonals
            # so the triangular solve stays finite (the affected directions
            # then deflate nothing instead of poisoning the solve)
            d = jnp.diagonal(R)
            dsafe = jnp.where(jnp.abs(d) > 1e-30, d, 1e-30)
            R = R - jnp.diag(d) + jnp.diag(dsafe)
            C = Q.T                                 # (k, n) orthonormal rows
            Ur = jax.scipy.linalg.solve_triangular(R.T, Ur, lower=True)
        else:
            # matvecs unrolled (static k): each application halo-exchanges,
            # and collectives cannot ride inside vmap under shard_map
            AU = jnp.stack([mv(Ur[i]) for i in range(k)])
            C, L = cholqr(AU)                       # C = R^-T (A U), L = R^T
            Ur = jax.scipy.linalg.solve_triangular(L, Ur, lower=True)
    else:
        C = pv(jnp.zeros((k, n), dtype))
        Ur = pv(jnp.zeros((k, n), dtype))

    def cycle(x, total_iters):
        r = bf - mv(x)
        if have_U:
            q = ar(matmul(C, r))
            x = x + matmul(Ur.T, q)
            r = r - matmul(C.T, q)
        beta = jnp.sqrt(ar(jnp.sum(r * r)))

        V = pv(jnp.zeros((m + 1, n), dtype))
        Z = pv(jnp.zeros((m, n), dtype))
        B = jnp.zeros((k, m), dtype)
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)
        V = V.at[0].set(r / jnp.maximum(beta, 1e-300))

        def cond(carry):
            V, Z, B, H, cs, sn, g, j, res = carry
            return (j < m) & (res > tol)

        def body(carry):
            V, Z, B, H, cs, sn, g, j, _ = carry
            z = pcf(V[j])
            w = mv(z)
            Z = Z.at[j].set(z)
            if have_U:
                bcol = ar(matmul(C, w))
                w = w - matmul(C.T, bcol)
                B = B.at[:, j].set(bcol)

            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            h = ar(matmul(V, w)) * mask
            w = w - matmul(V.T, h)
            h2 = ar(matmul(V, w)) * mask
            w = w - matmul(V.T, h2)
            h = h + h2
            hn = jnp.sqrt(ar(jnp.sum(w * w)))
            V = V.at[j + 1].set(w / jnp.maximum(hn, 1e-300))
            hcol = h.at[j + 1].set(hn)

            def rot(i, hc):
                t1 = cs[i] * hc[i] + sn[i] * hc[i + 1]
                t2 = -sn[i] * hc[i] + cs[i] * hc[i + 1]
                return hc.at[i].set(t1).at[i + 1].set(t2)
            hcol = jax.lax.fori_loop(0, j, rot, hcol)

            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c_new = hcol[j] / jnp.maximum(denom, 1e-300)
            s_new = hcol[j + 1] / jnp.maximum(denom, 1e-300)
            hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            g_new = g.at[j + 1].set(-s_new * g[j]).at[j].set(c_new * g[j])

            H = H.at[:, j].set(hcol)
            res = jnp.abs(g_new[j + 1])
            return (V, Z, B, H, cs, sn, g_new, j + 1, res)

        carry = (V, Z, B, H, cs, sn, g, jnp.array(0), beta)
        V, Z, B, H, cs, sn, g, j, res = jax.lax.while_loop(cond, body, carry)

        used = jnp.arange(m) < j
        Rt = H[:m, :m] * used[None, :] * used[:, None]
        Rt = Rt + jnp.diag(jnp.where(used, 0.0, 1.0))
        rhs_t = jnp.where(used, g[:m], 0.0)

        def back(i, y):
            kk = m - 1 - i
            yk = (rhs_t[kk] - dot(Rt[kk], y)) / Rt[kk, kk]
            return y.at[kk].set(yk)
        y = jax.lax.fori_loop(0, m, back, jnp.zeros(m, dtype))
        x = x + matmul(Z.T, y)
        if have_U:
            x = x - matmul(Ur.T, matmul(B, y))
        return x, total_iters + j, res, (V, Z, B, H, j)

    x = x0.reshape(n)
    iters = jnp.array(0)
    arn = None
    for c in range(ncycles):
        if c == 0:
            x, iters, res, arn = cycle(x, iters)
        else:
            x, iters, res, arn = jax.lax.cond(
                res > tol,
                lambda carry: cycle(carry[0], carry[1]),
                lambda carry: carry,
                (x, iters, res, arn))

    # ---- harvest the next recycle space from the LAST cycle's relation
    # A [Ur; Z] = [C; V] G,  G = [[I_k, B], [0, Hbar]]  (exact)
    V, Z, B, H, j = arn
    used = jnp.arange(m) < j
    G = jnp.zeros((k + m + 1, k + m), dtype)
    if have_U:
        G = G.at[:k, :k].set(jnp.eye(k, dtype=dtype))
        G = G.at[:k, k:].set(B * used[None, :].astype(dtype))
    Hm = H * used[None, :].astype(dtype)
    G = G.at[k:, k:].set(Hm)
    # unused Arnoldi columns get a huge unit diagonal so their (exact)
    # singular triplets sort to the top and are never harvested
    big = jnp.where(used, 0.0, 1e8).astype(dtype)
    G = G.at[jnp.arange(k, k + m), jnp.arange(k, k + m)].add(big)
    if not have_U:
        # without a previous space the first k columns are all-zero: give
        # them the same huge diagonal so they are not selected either
        G = G.at[jnp.arange(k), jnp.arange(k)].set(jnp.asarray(1e8, dtype))
    _, _, Vh = jnp.linalg.svd(G, full_matrices=False)
    Y = Vh[-k:, :]                                  # k smallest, (k, k+m)
    ZU = jnp.concatenate([Ur, Z], axis=0)           # (k+m, n)
    U_new = matmul(Y, ZU)                           # (k, n)
    # ORTHONORMALIZE the harvested space (span is all that matters; C is
    # rebuilt from A U next solve). Without this the recycled directions
    # collapse toward the same slow modes across Newton steps, R^-T U
    # amplifies wildly, and the f32 U-space correction x -= U (B y)
    # cancels catastrophically — measured: outer Newton 79 -> 143 steps.
    U_new = jnp.where(jnp.isfinite(U_new), U_new, 0.0)
    if axis_name is None:
        Qh, _ = jnp.linalg.qr(U_new.T)              # (n, k) orthonormal
        U_new = Qh.T
    else:
        U_new, _ = cholqr(U_new)
    return (x.reshape(shape), iters, res / jnp.maximum(bnorm, 1e-300),
            U_new.reshape((k,) + shape))
