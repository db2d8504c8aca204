"""Banded (shifted-slice) neighbour encoding for the block linear stack.

In the slot-block matvec and the block-Jacobi/SGS sweeps, every Krylov
iteration gathers the (NC, slots, V, V) neighbour operand through
`cell_nbrs`. On GENERATED structured meshes (the O-mesh families driving
the large-mesh benchmarks) the neighbour index is almost everywhere
`cell + d` for a handful of fixed offsets d — e.g. a ni x nj cylinder
O-mesh in row-major order has exactly SIX offsets: {-nj, -1, +1, +nj} in
the interior plus the two circumferential seam offsets +-(n_cells - nj),
covering 100% of the valid slots (measured).

When that holds, the per-iteration gather collapses to K contiguous
`jnp.roll` slices + batched einsums — pure streaming instead of
element-at-a-time gathers (on the H100 the gather matvec ties it; see
PERF.md). The reference meets the same need with its RCM / line orderings
feeding banded-friendly ILU (FVENS
src/mesh/meshordering.cpp, testcases/defaults.solverc -mesh_reorder rcm);
here the answer is to exploit the band structure directly.

Opt-in via LinearSolverConfig(banded=True): the summation order over
neighbours differs from the gather path (band order instead of slot
order), so results agree only to rounding; the default solver path stays
bit-identical. Falls back to the gather path (structure build returns
None) whenever the mesh is not band-coverable — e.g. the unstructured
hybrid NACA meshes, whose offset histogram is too flat (top-64 offsets
cover 64% after RCM).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .precision import einsum


@partial(jax.tree_util.register_dataclass,
         data_fields=["slot_sel", "valid", "rest_cell", "rest_slot",
                      "rest_nbr", "rest_valid"],
         meta_fields=["offsets"])
@dataclasses.dataclass(frozen=True)
class BandedStructure:
    """Static band encoding of a CompiledMesh's neighbour slots.

    offsets:  K Python ints (static): band k holds neighbours at cell + d_k.
    slot_sel: (K, NC) int32 — which slot of cell_nbrs holds that neighbour
              (clamped to 0 where the band is absent; see valid).
    valid:    (K, NC) int8 — 1 where cell c really has a neighbour at
              offset d_k (selected blocks are multiplied by this).

    rest_*: compact COO list of the valid slots NOT covered by any band
    (empty on fully band-coverable meshes — the single-chip generated-mesh
    case). The hybrid operators apply bands as rolls and the rest as one
    small gather + scatter-add; this is what makes the encoding usable on
    partitioned meshes, where cells on the partition seam point at halo
    slots appended after the owned range (dist/partition.py) and so fall
    off the interior bands.
      rest_cell:  (NR,) int32 — row the uncovered block belongs to
                  (== NC on padding entries: scatter mode='drop').
      rest_slot:  (NR,) int32 — which cell_nbrs slot it came from.
      rest_nbr:   (NR,) int32 — the neighbour index it points at (in
                  range; 0 on padding, masked by rest_valid).
      rest_valid: (NR,) int8.
    """
    offsets: tuple
    slot_sel: jnp.ndarray
    valid: jnp.ndarray
    rest_cell: jnp.ndarray
    rest_slot: jnp.ndarray
    rest_nbr: jnp.ndarray
    rest_valid: jnp.ndarray


def banded_structure(mesh, max_bands: int = 8):
    """Host-side band analysis of mesh.cell_nbrs (NumPy, outside jit).

    Returns a BandedStructure covering EVERY valid neighbour slot with at
    most `max_bands` offsets, or None when the mesh is not band-coverable
    (the caller then keeps the gather path). Requiring 100% coverage keeps
    the banded operators exactly equivalent (up to summation order) to the
    slot-gather operators — there is no exception list to maintain.
    """
    nb = np.asarray(mesh.cell_nbrs)
    mask = np.asarray(mesh.nbr_mask) > 0          # the Jacobian's zero rule
    NC = nb.shape[0]
    off = nb - np.arange(NC, dtype=nb.dtype)[:, None]
    offs, counts = np.unique(off[mask], return_counts=True)
    if len(offs) > max_bands:
        return None
    order = np.argsort(-counts)
    offsets = tuple(int(offs[k]) for k in order)
    slot_sel = np.zeros((len(offsets), NC), dtype=np.int32)
    valid = np.zeros((len(offsets), NC), dtype=np.int8)
    for k, d in enumerate(offsets):
        hit = mask & (off == d)                   # (NC, S)
        has = hit.any(axis=1)
        slot_sel[k] = np.where(has, hit.argmax(axis=1), 0)
        valid[k] = has
    # every valid slot must land in exactly one band
    if int(valid.sum()) != int(mask.sum()):
        return None
    nr0 = np.zeros(0, np.int32)
    return BandedStructure(offsets=offsets,
                           slot_sel=jnp.asarray(slot_sel),
                           valid=jnp.asarray(valid),
                           rest_cell=jnp.asarray(nr0),
                           rest_slot=jnp.asarray(nr0),
                           rest_nbr=jnp.asarray(nr0),
                           rest_valid=jnp.asarray(nr0.astype(np.int8)))


def banded_structure_parts(nb, mask, max_bands: int = 8,
                           min_cover: float = 0.5,
                           max_rest_frac: float = 0.75):
    """Band analysis of PARTITIONED neighbour tables (dist/partition.py).

    nb:   (D, NC, S) stacked shard-local cell_nbrs (own cells first, halo
          slots appended — partition_mesh's local numbering).
    mask: (D, NC, S) stacked nbr_mask > 0.

    The offsets must be a single static tuple SHARED by every shard (the
    shard_map body is one program), so they are chosen from the GLOBAL
    offset histogram; per-part coverage then differs only in the valid
    masks. Slots no band covers — dominated by seam cells pointing at halo
    slots — go to the per-part compact rest list, padded to the max count
    across parts. Returns a stacked BandedStructure (leaves (D, ...)) or
    None when bands would cover less than `min_cover` of the valid slots
    (the caller keeps the gather path, same contract as
    banded_structure)."""
    nb = np.asarray(nb)
    mask = np.asarray(mask) > 0
    D, NC, S = nb.shape
    off = nb - np.arange(NC, dtype=nb.dtype)[None, :, None]
    offs, counts = np.unique(off[mask], return_counts=True)
    if len(offs) == 0:
        return None
    order = np.argsort(-counts)[:max_bands]
    cover = counts[order].sum() / max(1, mask.sum())
    if cover < min_cover:
        return None
    offsets = tuple(int(offs[k]) for k in order)

    K = len(offsets)
    slot_sel = np.zeros((D, K, NC), np.int32)
    valid = np.zeros((D, K, NC), np.int8)
    covered = np.zeros_like(mask)
    for k, d in enumerate(offsets):
        hit = mask & (off == d) & ~covered            # (D, NC, S)
        # only the FIRST slot at this offset joins the band (a cell can
        # have two neighbours at the same offset through a periodic seam);
        # later duplicates stay uncovered and fall into the rest list
        first = hit & (np.cumsum(hit, axis=2) == 1)
        has = first.any(axis=2)
        slot_sel[:, k] = np.where(has, first.argmax(axis=2), 0)
        valid[:, k] = has
        covered |= first
    rest = mask & ~covered
    nrs = rest.reshape(D, -1).sum(axis=1)
    NR = int(nrs.max())
    if NR > max_rest_frac * mask.sum() / D:
        return None
    rest_cell = np.full((D, NR), NC, np.int32)        # pad -> scatter-drop
    rest_slot = np.zeros((D, NR), np.int32)
    rest_nbr = np.zeros((D, NR), np.int32)
    rest_valid = np.zeros((D, NR), np.int8)
    for p in range(D):
        cells, slots = np.nonzero(rest[p])
        n = cells.size
        rest_cell[p, :n] = cells
        rest_slot[p, :n] = slots
        rest_nbr[p, :n] = nb[p, cells, slots]
        rest_valid[p, :n] = 1
    return BandedStructure(offsets=offsets,
                           slot_sel=jnp.asarray(slot_sel),
                           valid=jnp.asarray(valid),
                           rest_cell=jnp.asarray(rest_cell),
                           rest_slot=jnp.asarray(rest_slot),
                           rest_nbr=jnp.asarray(rest_nbr),
                           rest_valid=jnp.asarray(rest_valid))


def banded_blocks(bl: BandedStructure, N):
    """Reorder per-slot neighbour blocks (NC, S, V, V) into per-band blocks
    (K, V, V, NC): B[k, :, :, c] = N[c, slot_sel[k, c]] (zero where the
    band is absent). Paid once per Newton step — it replaces a gather PER
    KRYLOV ITERATION.

    The cell axis is LAST, so every per-band operand is a contiguous
    NC-long stream and the V x V block dims index whole streams. The slot
    select is a masked sum over the S (<= ~5) slots instead of a gather:
    S small streamed passes and no scatter/gather. This layout was chosen
    for an earlier accelerator's tiled memory; whether the plain slot
    gather does as well on the GPU is ROADMAP S8."""
    S = N.shape[1]
    Nt = jnp.moveaxis(N, 0, -1)                       # (S, V, V, NC)
    vm = bl.valid.astype(N.dtype)                     # (K, NC)
    out = None
    for s in range(S):
        m = jnp.where(bl.slot_sel == s, vm, 0)        # (K, NC)
        term = m[:, None, None, :] * Nt[s][None]      # (K, V, V, NC)
        out = term if out is None else out + term
    return out


def _block_mv(Bt, xt):
    """y[i,c] = sum_j Bt[i,j,c] x[j,c] as a broadcast multiply-reduce.

    Not an einsum: a c-batched 4x4 dot_general makes XLA transpose the
    operand to batch-major, while the multiply-reduce keeps the NC-minor
    layout of banded_blocks and fuses into one loop over the cells. On the
    H100 this matvec streams within 2x of the copy bandwidth; whether the
    einsum form would do as well there was not measured (ROADMAP S8)."""
    return (Bt * xt[None, :, :]).sum(axis=1)


def banded_dn_blocks(bl: BandedStructure, Dinv, N):
    """Band-reordered (K, V, V, NC) blocks of D^-1 N for the banded bsgs
    sweeps, WITHOUT materializing the (NC, S, V, V) product (same NC-minor
    layout as banded_blocks). Select bands from N first (K <= S), then
    multiply by D^-1 in the NC-minor layout (broadcast-sum, not einsum:
    see _block_mv)."""
    Bt = banded_blocks(bl, N)                         # (K, V, V, NC)
    Dt = jnp.moveaxis(Dinv, 0, -1)                    # (V, V, NC)
    # out[k,i,l,c] = sum_j Dt[i,j,c] Bt[k,j,l,c]
    return (Dt[None, :, :, None, :] * Bt[:, None, :, :, :]).sum(axis=2)


def rest_blocks(bl: BandedStructure, N):
    """Compact (NR, V, V) blocks of the slots no band covers:
    R[r] = N[rest_cell[r], rest_slot[r]] (zero on padding). Like
    banded_blocks, one small gather paid once per Newton step."""
    if bl.rest_cell.shape[0] == 0:
        return None
    c = jnp.minimum(bl.rest_cell, N.shape[0] - 1)
    R = N[c, bl.rest_slot]
    return R * bl.rest_valid[:, None, None].astype(N.dtype)


def rest_dn_blocks(bl: BandedStructure, Dinv, N):
    """rest_blocks of D^-1 N, computed on the compact rest list only
    (NR blocks) so the full-size product is never formed."""
    R = rest_blocks(bl, N)
    if R is None:
        return None
    c = jnp.minimum(bl.rest_cell, N.shape[0] - 1)
    return einsum("rij,rjl->ril", Dinv[c], R)


def _rest_apply(bl: BandedStructure, R, x, y, sign=1.0):
    """y += sign * scatter-add of R_r x[rest_nbr_r] at rows rest_cell_r.
    Padding rows carry rest_cell == NC: dropped by the scatter."""
    contrib = einsum("rij,rj->ri", R, x[bl.rest_nbr])
    return y.at[bl.rest_cell].add(sign * contrib, mode="drop")


def _norm_offsets(offsets, NC):
    """Normalize roll offsets into (-NC/2, NC/2]: jnp.roll is modular, so
    the O-mesh seam offsets +-(NC - nj) are really just -+nj — this is what
    keeps the shifted-window padding small (P = max|d| <= nj, not ~NC)."""
    out = []
    for d in offsets:
        dm = d % NC
        if dm > NC // 2:
            dm -= NC
        out.append(dm)
    return tuple(out)


def _shifted_windows(xt, dms, P):
    """All K shifts of xt (V, NC) as STATIC slices of one wrap-padded copy
    (zp[:, j] = xt[:, (j - P) mod NC], so zp[:, P+d : P+d+NC] ==
    jnp.roll(xt, -d)). One (V, NC+2P) concat per apply replaces K full
    roll materializations — rolls lower to slice+concat copies of the
    whole vector, which doubled the memory traffic of every banded sweep;
    static slices fuse into the consuming
    einsums."""
    NC = xt.shape[1]
    if P == 0:
        return [xt for _ in dms]
    zp = jnp.concatenate([xt[:, NC - P:], xt, xt[:, :P]], axis=1)
    return [zp[:, P + d:P + d + NC] for d in dms]


def make_banded_matvec(D, Bt, offsets, bl=None, R=None):
    """mv(x) = D x + sum_k B_k (x shifted by d_k) [+ rest scatter]: K
    shifted static slices + cell-batched 4x4 multiply-reduces instead of
    the per-iteration (NC, S) index gather. The whole apply runs
    transposed — vectors as (V, NC), blocks as (K, V, V, NC) from
    banded_blocks — so the cell axis stays minor (see banded_blocks and
    _block_mv). Exactly equivalent to the
    slot-gather matvec up to neighbour summation order (valid-masked
    blocks are zero; wrapped-around window values only ever multiply
    zeros). When the structure carries a rest list (partitioned meshes:
    seam cells point at halo slots), those few blocks are applied as one
    compact gather + scatter-add (R = rest_blocks(bl, N))."""
    Dt = jnp.moveaxis(D, 0, -1)                       # (V, V, NC)
    NC = D.shape[0]
    dms = _norm_offsets(offsets, NC)
    P = max((abs(d) for d in dms), default=0)

    def mv(x):
        xt = x.T                                      # (V, NC)
        win = _shifted_windows(xt, dms, P)
        yt = _block_mv(Dt, xt)
        for k in range(len(dms)):
            yt = yt + _block_mv(Bt[k], win[k])
        y = yt.T
        if R is not None:
            y = _rest_apply(bl, R, x, y)
        return y
    return mv


def make_banded_bsgs(Dinv, DNbt, offsets, sweeps: int, bl=None, DNr=None):
    """Banded form of the pc='bsgs' damped block-Jacobi sweeps
    (solver/linear.py make_preconditioner): z' = D^-1 v - (D^-1 N) z_nbr
    with the neighbour product as shifted static slices (see
    _shifted_windows), in the same transposed (V, NC) layout as
    make_banded_matvec. DNbt = banded_dn_blocks; DNr = rest_dn_blocks
    (partitioned meshes; the transposes around the compact rest scatter
    are paid only there)."""
    Dt = jnp.moveaxis(Dinv, 0, -1)                    # (V, V, NC)
    NC = Dinv.shape[0]
    dms = _norm_offsets(offsets, NC)
    P = max((abs(d) for d in dms), default=0)

    def pc(v):
        dvt = _block_mv(Dt, v.T)                      # (V, NC)
        z = dvt
        for _ in range(sweeps):
            win = _shifted_windows(z, dms, P)
            acc = dvt
            for k in range(len(dms)):
                acc = acc - _block_mv(DNbt[k], win[k])
            if DNr is not None:
                acc = _rest_apply(bl, DNr, z.T, acc.T, sign=-1.0).T
            z = acc
        return z.T
    return pc
