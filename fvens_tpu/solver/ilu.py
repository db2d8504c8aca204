"""Block ILU(0) preconditioner in fixed-point (Chow-Patel) form.

The reference's default preconditioner is bjacobi+ILU0 via BLASTed
(testcases/defaults.solverc:16-19, src/linalg/alinalg.cpp:301-384), whose
async-sweep variant (perftest/threads_async.cpp) computes the incomplete
factors by parallel FIXED-POINT SWEEPS instead of the sequential IKJ loop
(Chow & Patel, "Fine-grained parallel incomplete LU factorization", SISC
2015 - the algorithm BLASTed implements). That formulation is exactly what
maps to a data-parallel device:

  - factorization: every block-nonzero's ILU0 equation
        L_ij = (A_ij - sum_{k<j} L_ik U_kj) U_jj^{-1}      (i > j)
        U_ij =  A_ij - sum_{k<i} L_ik U_kj                 (i <= j)
    is updated SIMULTANEOUSLY from the previous iterate - batched 4x4
    einsums plus slot gathers, no ordering, no levels;
  - application: the triangular solves are replaced by a truncated
    Neumann/Jacobi iteration (BLASTed's "async triangular solve"),
        y^{t+1} = v - L y^t,       z^{t+1} = Ud^{-1} (y - Us z^t),
    again just slot gathers + batched einsums.

Sparsity bookkeeping is precomputed on the host per mesh (ILUStructure,
a static-int pytree passed as a jit argument): the fill-in intersection
k in nbr(i) & nbr(j), k < min(i,j) is resolved to slot indices once. On
2-D face-adjacency graphs these triangular closures are rare (three cells
pairwise sharing faces), so the correction tensors are almost empty - but
they are carried exactly, so with enough sweeps the fixed point IS the
exact ILU0 factorization (tests/test_solvers.py gates this).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .precision import einsum


class ILUStructure(NamedTuple):
    """Static (per-mesh) slot bookkeeping for the fixed-point block ILU0."""
    rs: jnp.ndarray         # (NC,K) i32: slot in row nbr(c,k) pointing back
    #                         at c (the (nbr,c) block's storage slot)
    lower: jnp.ndarray      # (NC,K) f32 1.0 where nbr(c,k) < c (valid slots)
    upper: jnp.ndarray      # (NC,K) f32 1.0 where nbr(c,k) > c (valid slots)
    fill_sb: jnp.ndarray    # (NC,K,K) i32: for target slot s of row c and
    #                         source slot a (k = nbr(c,a)): the slot of row k
    #                         holding the (k, nbr(c,s)) block
    fill_mask: jnp.ndarray  # (NC,K,K) f32 1.0 where the ILU0 correction term
    #                         L_ck U_kj (k < min(c, j), k in nbr(c) & nbr(j))
    #                         exists


def ilu_structure(mesh) -> ILUStructure:
    """Host-side sparsity analysis (cached per mesh by the solver)."""
    nbrs = np.asarray(mesh.cell_nbrs)
    mask = np.asarray(mesh.nbr_mask) > 0
    NC, K = nbrs.shape
    cells = np.arange(NC)
    safe = np.clip(nbrs, 0, NC - 1)

    # reverse slots: nbrs[nbr(c,k)] == c
    nn = nbrs[safe]                                   # (NC,K,K)
    eq = nn == cells[:, None, None]
    rs = eq.argmax(axis=2).astype(np.int32)

    j = nbrs
    lower = mask & (j < cells[:, None])
    upper = mask & (j > cells[:, None])

    # fill terms for off-diagonal slot (c,s) -> j: source slot a with
    # k = nbr(c,a), k < min(c,j), and j in nbr(k) at slot sb
    eq2 = nn[:, None, :, :] == j[:, :, None, None]    # (NC,s,a,sb)
    sb = eq2.argmax(axis=3).astype(np.int32)          # (NC,K,K)
    has = eq2.any(axis=3)
    kmat = np.broadcast_to(nbrs[:, None, :], (NC, K, K))
    jmat = np.broadcast_to(j[:, :, None], (NC, K, K))
    fmask = (has
             & np.broadcast_to(mask[:, None, :], (NC, K, K))   # (c,a) valid
             & np.broadcast_to(mask[:, :, None], (NC, K, K))   # (c,s) valid
             & (kmat < np.minimum(cells[:, None, None], jmat)))

    f4 = np.float32
    return ILUStructure(
        rs=jnp.asarray(rs),
        lower=jnp.asarray(lower.astype(f4)),
        upper=jnp.asarray(upper.astype(f4)),
        fill_sb=jnp.asarray(sb),
        fill_mask=jnp.asarray(fmask.astype(f4)),
    )


def ilu_factorize(mesh, jac, st: ILUStructure, sweeps: int = 4):
    """Fixed-point block-ILU0 factorization (device, per Newton step).

    Returns (L, Ud, Udinv, Us): strictly-lower blocks of the unit-lower
    factor (slot layout, zero off-pattern), the upper factor's diagonal
    blocks, their inverses, and the strictly-upper blocks. With
    sweeps >= the factorization dependency depth the result is the exact
    ILU0 factors; small sweep counts give the Chow-Patel approximation.
    """
    from .linear import _nbrs_in_range, block_jacobi_inverse

    nbrs = _nbrs_in_range(mesh)
    D, N = jac.D, jac.N
    dt = D.dtype
    NC, K = nbrs.shape
    lm = st.lower.astype(dt)[..., None, None]          # (NC,K,1,1)
    um = st.upper.astype(dt)[..., None, None]
    fm = st.fill_mask.astype(dt)[..., None, None]      # (NC,K,K,1,1)
    kk = jnp.broadcast_to(nbrs[:, None, :], st.fill_sb.shape)  # (NC,s,a)

    Ud = D
    Udinv = block_jacobi_inverse(Ud)
    Us = N * um
    L = einsum("caij,cajl->cail", N * lm, Udinv[nbrs])

    for _ in range(sweeps):
        # upper storage incl. the implicit diagonal for the U_kj gather:
        # the (k, j) block with k < j lives in Us; the sb slot indexing is
        # built only over off-diagonal targets, so Us suffices
        Ukj = Us[kk, st.fill_sb] * fm                  # (NC,s,a,V,V)
        corr = einsum("caij,csajl->csil", L, Ukj)  # sum over a and j
        S = N - corr                                   # (NC,K,V,V)

        # diagonal: Ud_c = D_c - sum_{a: nbr<c} L_ca U_{nbr(c,a), c}
        Urev = Us[nbrs, st.rs] * lm                    # (NC,K,V,V)
        Ud = D - einsum("caij,cajl->cil", L, Urev)
        Udinv = block_jacobi_inverse(Ud)

        Us = S * um
        L = einsum("caij,cajl->cail", S * lm, Udinv[nbrs])

    return L, Ud, Udinv, Us


def make_ilu_apply(mesh, L, Udinv, Us, sweeps: int = 3):
    """pc(v) ~= (L U)^{-1} v with truncated-Neumann triangular solves.

    Lower solve (unit-lower): y <- v - L y, `sweeps` times (y0 = v).
    Upper solve:              z <- Udinv (y - Us z), `sweeps` times
    (z0 = Udinv y). Each sweep is one (NC,K,V) neighbour-row gather plus
    batched 4x4 einsums - identical device shape to a bsgs sweep, so per
    unit wall the preconditioner strength is what's being bought.
    """
    from .linear import _nbrs_in_range

    nbrs = _nbrs_in_range(mesh)

    def pc(v):
        y = v
        for _ in range(sweeps):
            y = v - einsum("ckij,ckj->ci", L, y[nbrs])
        z = einsum("cij,cj->ci", Udinv, y)
        for _ in range(sweeps):
            z = einsum("cij,cj->ci", Udinv,
                           y - einsum("ckij,ckj->ci", Us, z[nbrs]))
        return z

    return pc
