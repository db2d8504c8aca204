"""Line-implicit smoothing structures.

Boundary-layer meshes couple cells strongly across the wall-normal
direction; point-block smoothers converge slowly there. The reference
detects such "lines" for ordering only (FVENS src/mesh/meshordering.cpp:
33-66); here they drive a block-TRIDIAGONAL solve along each line inside
the preconditioner (pc="bline"), batched over all lines with a scanned
Thomas algorithm - the batched replacement for ILU's sequential strength.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .precision import einsum


@partial(jax.tree_util.register_dataclass,
         data_fields=["line_cells", "line_mask", "dn_slot", "up_slot",
                      "dn_valid", "up_valid", "line_slot_mask",
                      "cell_line_pos"],
         meta_fields=["n_lines", "Lmax"])
@dataclasses.dataclass(frozen=True)
class LineStructure:
    """Padded line arrays. NL lines of up to Lmax cells; every real cell
    appears in exactly one line (isolated cells form length-1 lines)."""
    line_cells: jnp.ndarray      # (NL, Lmax) int32 cell ids, pad = NC-1
    line_mask: jnp.ndarray       # (NL, Lmax) 1.0 for real entries
    dn_slot: jnp.ndarray         # (NL, Lmax) int32 slot of cell i -> i-1 (0 pad)
    up_slot: jnp.ndarray         # (NL, Lmax) int32 slot of cell i -> i+1 (0 pad)
    dn_valid: jnp.ndarray        # (NL, Lmax) 1.0 where dn_slot is a real link
    up_valid: jnp.ndarray        # (NL, Lmax) 1.0 where up_slot is a real link
    line_slot_mask: jnp.ndarray  # (NC, 4) 1.0 where the slot couples along a line
    cell_line_pos: jnp.ndarray   # (NC, 2) int32 (line, pos) of each cell
    n_lines: int
    Lmax: int


def build_lines(mesh_np_nbrs, mesh_np_mask, rc, nfael_active,
                NC: int, anisotropy_threshold: float = 2.0,
                max_len: int = 0) -> "LineStructure":
    """Greedy strong-coupling line detection on the compiled incidence.

    mesh_np_nbrs:  (NC,4) neighbour cell ids (numpy)
    mesh_np_mask:  (NC,4) 1 where the neighbour is a real cell
    rc:            (NC,2) cell centres
    nfael_active:  (NC,) number of active slots (for real cells)
    Coupling weight between adjacent cells = 1/distance(centres); a line is
    grown along the strongest coupling while the local max/min weight ratio
    exceeds `anisotropy_threshold` (meshordering details_lineordering.hpp).
    """
    from ..mesh.ordering import find_lines_core

    n_real = int(nfael_active.shape[0])
    nbrs = mesh_np_nbrs
    mask = mesh_np_mask

    # the same detection that passes the reference's golden-line test
    # (tests/common-input/testanisotropic-lines.txt): seed from boundary
    # cells first (reference behaviour), then from every remaining cell so
    # interior anisotropic regions also form lines for the smoother
    esuel = np.where(mask[:n_real] > 0, nbrs[:n_real], -1)
    nfael = np.full(n_real, esuel.shape[1], dtype=np.int64)
    bcells = np.flatnonzero((mask[:n_real] == 0).any(axis=1))
    seeds = np.concatenate([bcells, np.arange(n_real)])
    found, in_line = find_lines_core(esuel, nfael, rc[:n_real], seeds,
                                     anisotropy_threshold)
    if max_len:
        clipped = []
        for line in found:
            for s in range(0, len(line), max_len):
                clipped.append(line[s:s + max_len])
        found = clipped

    lines: list[list[int]] = list(found)
    # every remaining real cell becomes a singleton line (the smoother
    # needs each cell in exactly one line; singletons degenerate to
    # block-Jacobi there)
    for c in range(n_real):
        if in_line[c] < 0:
            lines.append([c])

    NL = len(lines)
    Lmax = max(len(l) for l in lines)
    line_cells = np.full((NL, Lmax), NC - 1, np.int32)
    line_mask = np.zeros((NL, Lmax))
    dn_slot = np.zeros((NL, Lmax), np.int32)
    up_slot = np.zeros((NL, Lmax), np.int32)
    dn_valid = np.zeros((NL, Lmax))
    up_valid = np.zeros((NL, Lmax))
    line_slot_mask = np.zeros((NC, 4))
    cell_line_pos = np.zeros((NC, 2), np.int32)

    def slot_between(c, nb):
        for k in range(4):
            if mask[c, k] > 0 and int(nbrs[c, k]) == nb:
                return k
        return -1

    for li, line in enumerate(lines):
        cells = list(line)
        for i, c in enumerate(cells):
            line_cells[li, i] = c
            line_mask[li, i] = 1.0
            cell_line_pos[c] = (li, i)
            if i > 0:
                k = slot_between(c, cells[i - 1])
                if k >= 0:
                    dn_slot[li, i] = k
                    dn_valid[li, i] = 1.0
                    line_slot_mask[c, k] = 1.0
            if i + 1 < len(cells):
                k = slot_between(c, cells[i + 1])
                if k >= 0:
                    up_slot[li, i] = k
                    up_valid[li, i] = 1.0
                    line_slot_mask[c, k] = 1.0

    return LineStructure(
        line_cells=jnp.asarray(line_cells),
        line_mask=jnp.asarray(line_mask),
        dn_slot=jnp.asarray(dn_slot),
        up_slot=jnp.asarray(up_slot),
        dn_valid=jnp.asarray(dn_valid),
        up_valid=jnp.asarray(up_valid),
        line_slot_mask=jnp.asarray(line_slot_mask),
        cell_line_pos=jnp.asarray(cell_line_pos),
        n_lines=NL, Lmax=Lmax)


def lines_from_mesh(mesh, anisotropy_threshold: float = 2.0,
                    max_len: int = 32) -> LineStructure:
    """Build LineStructure from a CompiledMesh (host pass).

    Lines are clipped to `max_len` for the smoother: clipped segments stay
    exact block-tridiagonal solves (the cut couplings are lagged like any
    off-line block), and a bounded length keeps the Thomas scan fully
    unrollable (see block_thomas)."""
    nbrs = np.asarray(mesh.cell_nbrs)
    mask = np.asarray(mesh.nbr_mask)
    rc = np.asarray(mesh.rc)
    nf = np.asarray(np.abs(np.asarray(mesh.cell_fsign)).sum(axis=1))[
        : mesh.n_cells]
    return build_lines(nbrs, mask, rc, nf, mesh.NC,
                       anisotropy_threshold=anisotropy_threshold,
                       max_len=max_len)


def block_thomas(a, b, c, d):
    """Batched block-tridiagonal solve along axis 1.

    a,b,c: (NL, L, V, V) sub/main/super diagonal blocks (a[.,0], c[.,L-1]
    ignored); d: (NL, L, V) right-hand sides. Returns x (NL, L, V).
    Sequential in L via lax.scan; fully batched over lines (the unit of
    work is a (NL, V, V) batched 4x4 solve per scan step). Short scans are
    fully unrolled: line lengths are clipped to ~32 by lines_from_mesh, and
    the unrolled form is faster for short L.
    """
    from .linear import block_jacobi_inverse

    NL, L, V, _ = b.shape
    unroll = True if L <= 64 else 8

    # forward elimination: w_i = (b_i - a_i q_{i-1})^-1 ;
    # q_i = w_i c_i ; y_i = w_i (d_i - a_i y_{i-1})
    def fwd(carry, inp):
        q_prev, y_prev = carry
        ai, bi, ci, di = inp
        m = bi - einsum("lij,ljk->lik", ai, q_prev)
        w = block_jacobi_inverse(m)
        qi = einsum("lij,ljk->lik", w, ci)
        yi = einsum("lij,lj->li", w, di - einsum("lij,lj->li",
                                                         ai, y_prev))
        return (qi, yi), (qi, yi)

    a_t = jnp.moveaxis(a, 1, 0)
    b_t = jnp.moveaxis(b, 1, 0)
    c_t = jnp.moveaxis(c, 1, 0)
    d_t = jnp.moveaxis(d, 1, 0)
    init = (jnp.zeros((NL, V, V), b.dtype), jnp.zeros((NL, V), b.dtype))
    _, (qs, ys) = jax.lax.scan(fwd, init, (a_t, b_t, c_t, d_t),
                               unroll=unroll)

    # back substitution: x_i = y_i - q_i x_{i+1}
    def bwd(x_next, inp):
        qi, yi = inp
        xi = yi - einsum("lij,lj->li", qi, x_next)
        return xi, xi

    _, xs = jax.lax.scan(bwd, jnp.zeros((NL, V), b.dtype), (qs, ys),
                         reverse=True, unroll=unroll)
    return jnp.moveaxis(xs, 0, 1)
