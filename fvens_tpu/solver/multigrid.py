"""Algebraic (aggregation) multigrid preconditioner for the block system.

The reference reaches ILU(0) strength through BLASTed's sequential
factorizations (FVENS src/linalg/alinalg.cpp:301-384, default PC
testcases/defaults.solverc:16-19). Sequential triangular sweeps are
latency-bound on a data-parallel device, so the route taken here to the
same Krylov-iteration reduction is a coarse
GRID: a smoothed defect correction transported through a hierarchy of
graph-aggregated levels, where every operation is a batched gather+einsum
(fine) shrinking geometrically with level.

Design:
  - Pairwise aggregation on the cell graph (Notay-style, two passes per
    level => aggregates of ~4 cells) with a GEOMETRIC strength measure
    w = face_len / centre_dist: on stretched boundary-layer cells the
    wall-normal neighbour dominates, so aggregates follow the strong
    coupling like line smoothers do. Host-side, once per mesh.
  - Galerkin coarse operators A_l = R A_{l-1} R^T with piecewise-constant
    R: each level stores a precomputed flat scatter map from parent slot
    blocks to coarse slot blocks, so the per-Newton-step coarse build is
    ONE jax.ops.segment_sum of (N*(S+1), V, V) blocks per level.
  - V-cycle with block-Jacobi defect-correction sweeps as the smoother
    (z' = D^-1 v - (D^-1 N) z_nbr, one slot gather + one einsum per
    sweep: the cheapest smoothing op) and a
    deeper sweep stack on the coarsest level.

Everything device-side is shape-static; the hierarchy is an integer pytree
passed as a jit ARGUMENT (program size stays O(1) in the mesh).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .linear import block_jacobi_inverse
from .precision import einsum, vdot


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@partial(jax.tree_util.register_dataclass,
         data_fields=["agg", "tgt", "c_mask", "c_nbrs", "c_nbr_mask"],
         meta_fields=["NCp", "S"])
@dataclasses.dataclass(frozen=True)
class MGLevel:
    """One coarsening step: parent level (Np cells, Sp neighbour slots)
    -> this level (NCp padded cells, S neighbour slots)."""
    agg: jnp.ndarray         # (Np,) int32 coarse cell of each parent cell;
    #                          parent padding rows point at NCp (dump row)
    tgt: jnp.ndarray         # (Np, Sp+1) int32 flat index into
    #                          NCp*(S+1) coarse slot blocks (diag slot 0);
    #                          dropped/zero parent slots -> NCp*(S+1) (dump)
    c_mask: jnp.ndarray      # (NCp,) 1.0 real coarse cell, 0.0 padding
    c_nbrs: jnp.ndarray      # (NCp, S) int32 coarse neighbours (self-padded,
    #                          clamped in range: masked blocks are zero)
    c_nbr_mask: jnp.ndarray  # (NCp, S) 1.0 where a real coarse edge
    NCp: int                 # padded coarse cell count
    S: int                   # coarse neighbour slots


@partial(jax.tree_util.register_dataclass, data_fields=["levels"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class MGHierarchy:
    levels: tuple            # tuple[MGLevel]


def _pairwise_pass(nbrs, mask, w, n_real):
    """One greedy strongest-neighbour matching pass (host). Returns
    (agg (n_real,) int64, n_agg). Cells are visited in index order (after
    RCM compilation that is a bandwidth-reducing order, which keeps
    aggregate ids nearly sorted for the device segment_sum)."""
    from ..native import pairwise_aggregate_native
    nat = pairwise_aggregate_native(nbrs, mask, w, n_real)
    if nat is not None:
        return nat
    agg = np.full(n_real, -1, dtype=np.int64)
    na = 0
    S = nbrs.shape[1]
    for c in range(n_real):
        if agg[c] >= 0:
            continue
        best, bw = -1, 0.0
        for k in range(S):
            if mask[c, k] <= 0:
                continue
            nb = int(nbrs[c, k])
            if nb >= n_real or agg[nb] >= 0:
                continue
            if w[c, k] > bw:
                best, bw = nb, w[c, k]
        agg[c] = na
        if best >= 0:
            agg[best] = na
        na += 1
    return agg, na


def _coarse_graph(nbrs, mask, w, agg, n_real, n_agg):
    """Aggregate the parent graph: coarse edges with summed weights.
    Returns (c_nbrs (n_agg, S), c_mask (n_agg, S), c_w (n_agg, S), S)."""
    S_p = nbrs.shape[1]
    ci = np.repeat(agg[:n_real], S_p)
    nb = nbrs[:n_real].reshape(-1)
    valid = (mask[:n_real].reshape(-1) > 0) & (nb < n_real) & (nb >= 0)
    cj = np.where(valid, agg[np.clip(nb, 0, n_real - 1)], -1)
    keep = valid & (cj >= 0) & (cj != ci)
    ei, ej, ew = ci[keep], cj[keep], w[:n_real].reshape(-1)[keep]
    # unique directed coarse edges with accumulated weights
    key = ei * np.int64(n_agg) + ej
    order = np.argsort(key, kind="stable")
    key_s, ei_s, ej_s, ew_s = key[order], ei[order], ej[order], ew[order]
    uniq, first = np.unique(key_s, return_index=True)
    wsum = (np.add.reduceat(ew_s, first) if uniq.size
            else np.zeros(0))
    ui, uj = ei_s[first], ej_s[first]
    deg = np.bincount(ui, minlength=n_agg) if ui.size else np.zeros(
        n_agg, np.int64)
    S = max(1, int(deg.max()) if deg.size else 1)
    c_nbrs = np.tile(np.arange(n_agg, dtype=np.int64)[:, None], (1, S))
    c_w = np.zeros((n_agg, S))
    c_msk = np.zeros((n_agg, S))
    slot = np.zeros(n_agg, dtype=np.int64)
    for e in range(ui.size):
        i = ui[e]
        k = slot[i]
        c_nbrs[i, k] = uj[e]
        c_w[i, k] = wsum[e]
        c_msk[i, k] = 1.0
        slot[i] += 1
    return c_nbrs, c_msk, c_w, S


def _slot_map(nbrs_p, mask_p, agg, c_nbrs, c_msk, n_real, n_agg,
              NCp, S, Np):
    """Flat Galerkin scatter map: parent slot blocks (Np, Sp+1) -> coarse
    flat index in NCp*(S+1) (+ dump NCp*(S+1))."""
    Sp = nbrs_p.shape[1]
    dump = NCp * (S + 1)
    tgt = np.full((Np, Sp + 1), dump, dtype=np.int64)
    slot_of = {}
    for i in range(n_agg):
        for k in range(S):
            if c_msk[i, k] > 0:
                slot_of[(i, int(c_nbrs[i, k]))] = k + 1
    for c in range(n_real):
        I = int(agg[c])
        tgt[c, 0] = I * (S + 1)                   # diagonal -> diagonal
        for k in range(Sp):
            if mask_p[c, k] <= 0:
                continue
            nb = int(nbrs_p[c, k])
            if nb >= n_real:
                continue
            J = int(agg[nb])
            if J == I:
                tgt[c, k + 1] = I * (S + 1)       # intra-aggregate -> diag
            else:
                ks = slot_of.get((I, J))
                if ks is not None:
                    tgt[c, k + 1] = I * (S + 1) + ks
    return tgt


def build_hierarchy(mesh, n_levels: int = 3, min_coarse: int = 32,
                    passes: int = 2) -> MGHierarchy:
    """Host-side hierarchy construction from a CompiledMesh.

    n_levels counts COARSENING steps (a 2-level method has n_levels=1).
    Stops early once a level would go below `min_coarse` cells."""
    nbrs = np.asarray(mesh.cell_nbrs).astype(np.int64)
    mask = np.asarray(mesh.nbr_mask).astype(np.float64)
    n_real = mesh.n_cells
    Np = mesh.NC
    # geometric strength: face length / centre distance
    w = np.asarray(mesh.slot_len) / np.maximum(np.asarray(mesh.slot_dist),
                                               1e-300)
    w = w * mask                       # ghost/padding slots are not edges

    levels = []
    for _ in range(n_levels):
        if n_real <= min_coarse:
            break
        # double pairwise aggregation: compose `passes` matchings
        agg = np.arange(n_real, dtype=np.int64)
        cur_nbrs, cur_mask, cur_w, cur_real = nbrs, mask, w, n_real
        for _p in range(passes):
            a1, na = _pairwise_pass(cur_nbrs, cur_mask, cur_w, cur_real)
            agg = a1[agg]
            cur_nbrs, cur_mask, cur_w, _S1 = _coarse_graph(
                cur_nbrs, cur_mask, cur_w, a1, cur_real, na)
            cur_real = na
            if na <= min_coarse:
                break
        n_agg = cur_real
        c_nbrs, c_msk, c_w = cur_nbrs, cur_mask, cur_w
        S = c_nbrs.shape[1]
        NCp = _round_up(max(n_agg, 1), 8)

        agg_full = np.full(Np, NCp, dtype=np.int64)       # padding -> dump
        agg_full[:n_real] = agg
        tgt = _slot_map(nbrs, mask, agg, c_nbrs, c_msk, n_real, n_agg,
                        NCp, S, Np)

        c_nbrs_pad = np.tile(np.arange(NCp, dtype=np.int64)[:, None],
                             (1, S))
        c_nbrs_pad[:n_agg] = np.clip(c_nbrs, 0, NCp - 1)
        c_msk_pad = np.zeros((NCp, S))
        c_msk_pad[:n_agg] = c_msk
        c_mask_arr = np.zeros(NCp)
        c_mask_arr[:n_agg] = 1.0

        levels.append(MGLevel(
            agg=jnp.asarray(agg_full, jnp.int32),
            tgt=jnp.asarray(tgt, jnp.int32),
            c_mask=jnp.asarray(c_mask_arr),
            c_nbrs=jnp.asarray(c_nbrs_pad, jnp.int32),
            c_nbr_mask=jnp.asarray(c_msk_pad),
            NCp=NCp, S=S))

        # next iteration coarsens this level (re-padded to NCp rows)
        nbrs = np.zeros((NCp, S), np.int64)
        nbrs[:n_agg] = np.clip(c_nbrs, 0, max(n_agg - 1, 0))
        mask = np.zeros((NCp, S))
        mask[:n_agg] = c_msk
        w = np.zeros((NCp, S))
        w[:n_agg] = c_w * c_msk
        n_real, Np = n_agg, NCp
    return MGHierarchy(levels=tuple(levels))


def _galerkin(level: MGLevel, D, N):
    """Coarse slot blocks from parent blocks via one segment_sum."""
    V = D.shape[-1]
    blocks = jnp.concatenate([D[:, None], N], axis=1)     # (Np, Sp+1, V, V)
    flat = blocks.reshape(-1, V, V)
    nseg = level.NCp * (level.S + 1) + 1
    cb = jax.ops.segment_sum(flat, level.tgt.reshape(-1),
                             num_segments=nseg)[:-1]
    cb = cb.reshape(level.NCp, level.S + 1, V, V)
    Dc = cb[:, 0]
    eye = jnp.eye(V, dtype=D.dtype)
    Dc = Dc + (1.0 - level.c_mask.astype(D.dtype))[:, None, None] * eye
    Nc = cb[:, 1:] * level.c_nbr_mask.astype(D.dtype)[..., None, None]
    return Dc, Nc


#: coarsest-level dense direct solve size cap (unknowns = cells * NVARS);
#: above this the coarsest level falls back to smoother sweeps
_DENSE_COARSE_MAX = 4096


def _densify(D, N, nbrs):
    """Slot-block operator -> dense (NC*V, NC*V). Masked neighbour slots
    carry zero blocks and self-pointing indices, so adding them is a no-op;
    padding rows carry identity diagonals (set in _galerkin)."""
    NC, V = D.shape[0], D.shape[-1]
    A = jnp.zeros((NC, NC, V, V), D.dtype)
    ar = jnp.arange(NC)
    A = A.at[ar, ar].add(D)
    rows = jnp.repeat(ar, N.shape[1])
    A = A.at[rows, nbrs.reshape(-1)].add(N.reshape(-1, V, V))
    return A.transpose(0, 2, 1, 3).reshape(NC * V, NC * V)


def make_mg_preconditioner(mesh, jac, hierarchy: MGHierarchy,
                           nu1: int = 2, nu2: int = 2,
                           coarse_sweeps: int = 10, cycles: int = 1):
    """Returns pc(v) ~= J^-1 v: `cycles` V(nu1,nu2)-cycles.

    jac: fine BlockJacobian (D (NC,V,V), N (NC,4,V,V)) with the pseudo-time
    term already added. All per-Newton-step tensors (coarse Galerkin
    operators, folded D^-1 N) are built HERE, once, and closed over.

    The coarsest level is solved EXACTLY (dense LU) when small enough: at
    high CFL the Jacobian loses diagonal dominance and Jacobi-form sweeps
    can diverge, which poisons the whole correction — the smoothers are
    only safe as *smoothers*, not as the coarse solve."""
    from .linear import _nbrs_in_range

    dtp = jac.D.dtype

    # per-level tensors, Galerkin-built ONCE per Newton step
    lev_ops = []          # (Dinv, DN, D, N, nbrs, lv-or-None)
    D, N = jac.D, jac.N
    nbrs = _nbrs_in_range(mesh)
    for lv in hierarchy.levels:
        Dinv = block_jacobi_inverse(D)
        DN = einsum("cij,ckjl->ckil", Dinv, N)
        lev_ops.append((Dinv, DN, D, N, nbrs, lv))
        D, N = _galerkin(lv, D, N)
        nbrs = lv.c_nbrs
    Dinv = block_jacobi_inverse(D)
    DN = einsum("cij,ckjl->ckil", Dinv, N)
    lev_ops.append((Dinv, DN, D, N, nbrs, None))
    nlev = len(lev_ops)

    V = jac.D.shape[-1]
    coarse_dense = D.shape[0] * V <= _DENSE_COARSE_MAX
    if coarse_dense:
        A_coarse = _densify(D, N, nbrs)
        lu_c, piv_c = jax.scipy.linalg.lu_factor(A_coarse)

        def coarse_solve(v):
            x = jax.scipy.linalg.lu_solve((lu_c, piv_c), v.reshape(-1))
            return x.reshape(v.shape)

    def smooth(Dinv, DN, nbrs, v, z, n):
        """n block-Jacobi defect-correction sweeps from initial z (None=0).
        Exact identity: z + D^-1 (v - (D+N) z) = D^-1 v - (D^-1 N) z_nbr."""
        if n <= 0:
            return z if z is not None else jnp.zeros_like(v)
        dv = einsum("cij,cj->ci", Dinv, v)
        if z is None:
            z, n = dv, n - 1
        for _ in range(n):
            z = dv - einsum("ckij,ckj->ci", DN, z[nbrs])
        return z

    def matvec(Dl, Nl, nbrs, x):
        blocks = jnp.concatenate([Dl[:, None], Nl], axis=1)
        self_idx = jnp.arange(Dl.shape[0], dtype=nbrs.dtype)
        idx = jnp.concatenate([self_idx[:, None], nbrs], axis=1)
        return einsum("ckij,ckj->ci", blocks, x[idx])

    def vcycle(l, v, z):
        Dinv, DN, Dl, Nl, nbrs, lv = lev_ops[l]
        if l == nlev - 1:
            if coarse_dense:
                x = coarse_solve(v)
                return x if z is None else x      # exact: initial z moot
            return smooth(Dinv, DN, nbrs, v, z, coarse_sweeps)
        z = smooth(Dinv, DN, nbrs, v, z, nu1)
        r = v - matvec(Dl, Nl, nbrs, z)
        rc = jax.ops.segment_sum(r, lv.agg,
                                 num_segments=lv.NCp + 1)[:-1]
        zc = vcycle(l + 1, rc, None)
        zc_ext = jnp.concatenate(
            [zc, jnp.zeros((1,) + zc.shape[1:], dtp)])
        e = zc_ext[lv.agg]
        # residual-minimizing correction scale (nonsymmetric safeguard):
        # piecewise-constant aggregation corrections overshoot on advective
        # operators; omega* = <r, Ae>/<Ae, Ae> makes the correction a
        # monotone residual step at the cost of one matvec
        Ae = matvec(Dl, Nl, nbrs, e)
        den = vdot(Ae, Ae)
        omega = jnp.where(den > 0, vdot(r, Ae) / jnp.maximum(den, 1e-300),
                          jnp.asarray(0.0, dtp)).astype(dtp)
        omega = jnp.clip(omega, 0.0, 2.0)
        z = z + omega * e
        return smooth(Dinv, DN, nbrs, v, z, nu2)

    def pc(v):
        z = vcycle(0, v, None)
        for _ in range(cycles - 1):
            z = vcycle(0, v, z)
        return z

    return pc
