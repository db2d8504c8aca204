"""The device mesh: unstructured topology compiled to static padded SoA arrays.

This is the central representational decision of the rebuild: the mesh is
compiled ONCE on the host (NumPy) into flat index maps and geometric
coefficient arrays, padded to fixed sizes; all numerics then run as
shape-static jitted JAX kernels:

    gather cell states by (f_left, f_right)
      -> vmapped pointwise flux kernels over the face batch
      -> per-cell incidence gather-sums (cell_faces/cell_fsign) instead of
         atomic scatter-adds (flow_spatial.cpp:551-561 in the reference).

Replaces the reference's UMesh + Spatial setup (FVENS src/mesh/mesh.hpp:26-499,
src/spatial/aspatial.cpp:37-240). Face ordering: physical-boundary faces first
[0, n_bfaces), then interior faces [n_bfaces, n_faces), then inert padding.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BCSpec, BC_NAMES, BC_PERIODIC
from .geometry import compute_geometry
from .reader import MeshData
from .topology import Topology, build_topology, compute_periodic_map

MAXNF = 4  # max faces per cell in 2D (quad)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def greedy_coloring(cell_nbrs: np.ndarray, nbr_mask: np.ndarray,
                    active: np.ndarray, NC: int):
    """Greedy coloring of the cell adjacency graph (<=4 neighbours in 2D, so
    <=5 colors). Only `active` cells are colored; returns
    (color_rows (n_colors, max_rows) int32 padded with NC-1,
     color_counts (n_colors,), n_colors).

    Drives the multicolor block-SGS preconditioner - the data-parallel
    answer to the reference's sequential ILU0/SGS sweeps (PETSc bjacobi+ilu and BLASTed
    async sweeps, SURVEY.md sec 2.9 item 3): cells of one color share no
    faces, so a whole color updates in one batched step.
    """
    n = cell_nbrs.shape[0]
    from ..native import greedy_coloring_native
    nat = greedy_coloring_native(cell_nbrs, nbr_mask, active)
    if nat is not None:
        color, n_colors = nat
    else:
        color = np.full(n, -1, dtype=np.int64)
        for c in range(n):
            if not active[c]:
                continue
            used = set()
            for k in range(cell_nbrs.shape[1]):
                if nbr_mask[c, k] > 0:
                    nb = int(cell_nbrs[c, k])
                    if nb < n and color[nb] >= 0:
                        used.add(color[nb])
            col = 0
            while col in used:
                col += 1
            color[c] = col
        n_colors = max(1, int(color.max()) + 1)
    groups = [np.flatnonzero(color == c) for c in range(n_colors)]
    max_rows = max(1, max(g.size for g in groups))
    rows = np.full((n_colors, max_rows), NC - 1, dtype=np.int32)
    counts = np.zeros(n_colors, dtype=np.int32)
    for c, g in enumerate(groups):
        rows[c, : g.size] = g
        counts[c] = g.size
    return rows, counts, n_colors


def build_slot_arrays(f_normal, f_dr_unit, f_dist, f_len,
                      bc_code, bc_v0, bc_v1, n_bfaces,
                      cell_faces, cell_fsign):
    """Per-cell-slot face geometry with the owner's orientation baked in
    (see CompiledMesh.slot_* docs). NumPy, host-side."""
    cf = cell_faces
    s = cell_fsign
    sn = f_normal[cf] * s[..., None]
    sn[s == 0] = np.array([1.0, 0.0])
    sdr = f_dr_unit[cf] * s[..., None]
    sdist = f_dist[cf]
    slen = f_len[cf] * np.abs(s)
    nb = max(n_bfaces, 1)
    cfb = np.clip(cf, 0, nb - 1)
    is_b = (cf < n_bfaces) & (s != 0)
    code = np.where(is_b, bc_code[cfb], -1).astype(np.int32)
    # periodic slots couple to the partner cell like interior faces
    code = np.where(code == BC_PERIODIC, -1, code)
    v0 = np.where(is_b, bc_v0[cfb], 0.0)
    v1 = np.where(is_b, bc_v1[cfb], 0.0)
    return sn, sdr, sdist, slen, code, v0, v1


@partial(jax.tree_util.register_dataclass,
         data_fields=[
             "f_left", "f_right", "f_normal", "f_len", "f_mid", "f_rpoint",
             "f_rcl", "f_rcr", "f_dr_unit", "f_dist", "f_wl", "f_wr",
             "f_w2", "f_dr",
             "area", "inv_area", "rc", "cell_mask",
             "cell_faces", "cell_fsign", "cell_nbrs", "nbr_mask",
             "wls_vinv", "clength", "color_rows", "color_counts",
             "slot_normal", "slot_dr_unit", "slot_dist", "slot_len",
             "slot_bc_code", "slot_v0", "slot_v1",
             "bc_code", "bc_v0", "bc_v1", "bc_tag",
         ],
         meta_fields=["n_cells", "n_bfaces", "n_ifaces", "NC", "NF",
                      "n_colors"])
@dataclasses.dataclass(frozen=True)
class CompiledMesh:
    """Static SoA mesh arrays. Shapes: NC = padded cells, NF = padded faces,
    NB = n_bfaces (unpadded; boundary faces are the prefix of the face list).
    """

    # --- faces ---
    f_left: jnp.ndarray      # (NF,) int32 left cell
    f_right: jnp.ndarray     # (NF,) int32 right cell; for physical boundary
    #                          faces: the partner cell for periodic, else the
    #                          left cell itself (unused - BC supplies the state)
    f_normal: jnp.ndarray    # (NF,2) unit normal, left -> right
    f_len: jnp.ndarray       # (NF,) face length (0 on padding)
    f_mid: jnp.ndarray       # (NF,2) face midpoint (quadrature point)
    f_rpoint: jnp.ndarray    # (NF,2) point at which the RIGHT state is
    #                          reconstructed: the face midpoint, except on
    #                          periodic faces where it is the PARTNER face's
    #                          midpoint (so both copies of a periodic pair
    #                          see identical left/right states -> exact
    #                          conservation; improves on the reference)
    f_rcl: jnp.ndarray       # (NF,2) left cell centre
    f_rcr: jnp.ndarray       # (NF,2) right cell centre (ghost centre on bdry)
    f_dr_unit: jnp.ndarray   # (NF,2) unit vector rcl -> rcr
    f_dist: jnp.ndarray      # (NF,) |rcr - rcl|
    f_wl: jnp.ndarray        # (NF,) inverse-distance interp weight, left
    f_wr: jnp.ndarray        # (NF,) inverse-distance interp weight, right
    f_w2: jnp.ndarray        # (NF,) least-squares weight 1/dist^2
    f_dr: jnp.ndarray        # (NF,2) rcl - rcr (least-squares direction)

    # --- cells ---
    area: jnp.ndarray        # (NC,)
    inv_area: jnp.ndarray    # (NC,)
    rc: jnp.ndarray          # (NC,2)
    cell_mask: jnp.ndarray   # (NC,) 1.0 for real cells, 0.0 padding
    cell_faces: jnp.ndarray  # (NC,4) int32 face index of each local face
    cell_fsign: jnp.ndarray  # (NC,4) +1 cell is left, -1 right, 0 padding
    cell_nbrs: jnp.ndarray   # (NC,4) int32 neighbour across local face; for a
    #                          physical boundary face: NC + bface index (ghost
    #                          slot in the extended state array), padding: self
    nbr_mask: jnp.ndarray    # (NC,4) 1.0 if the neighbour is a real cell
    wls_vinv: jnp.ndarray    # (NC,2,2) inverse least-squares LHS
    clength: jnp.ndarray     # (NC,) characteristic length (Venkatakrishnan)
    color_rows: jnp.ndarray  # (n_colors, max_color_rows) cell ids per color
    #                          of a greedy adjacency coloring (padded with the
    #                          last padding cell) - drives multicolor SGS
    color_counts: jnp.ndarray  # (n_colors,) real rows per color

    # --- per-cell-slot face geometry (slot (c,k) = local face k of cell c).
    # Encodes the owner's orientation: slot_normal = sign * face normal, so
    # the slot flux is always flux(u_c, u_nbr, slot_normal) * slot_len and
    # the Jacobian can be assembled directly in per-cell layout with NO
    # block gathers (flux conservation identity f(a,b,n) = -f(b,a,-n)). ---
    slot_normal: jnp.ndarray   # (NC,4,2)
    slot_dr_unit: jnp.ndarray  # (NC,4,2) sign * dr_unit (thin-layer dir)
    slot_dist: jnp.ndarray     # (NC,4)
    slot_len: jnp.ndarray      # (NC,4) face length, 0 on padding slots
    slot_bc_code: jnp.ndarray  # (NC,4) int32 BC code or -1 (interior)
    slot_v0: jnp.ndarray       # (NC,4)
    slot_v1: jnp.ndarray       # (NC,4)

    # --- physical boundary faces (prefix of the face list) ---
    bc_code: jnp.ndarray     # (NB,) int32 BC type code (config.BC_*)
    bc_v0: jnp.ndarray       # (NB,) first BC parameter
    bc_v1: jnp.ndarray       # (NB,) second BC parameter
    bc_tag: jnp.ndarray      # (NB,) int32 mesh marker

    # --- static metadata ---
    n_cells: int
    n_bfaces: int
    n_ifaces: int
    NC: int
    NF: int
    n_colors: int

    @property
    def n_faces(self) -> int:
        return self.n_bfaces + self.n_ifaces

    @property
    def dtype(self):
        return self.area.dtype

    def astype(self, dtype) -> "CompiledMesh":
        """Cast all float arrays (indices stay integer)."""
        def cast(x):
            if jnp.issubdtype(x.dtype, jnp.floating):
                return x.astype(dtype)
            return x
        return jax.tree_util.tree_map(cast, self)

    @property
    def h_param(self) -> float:
        """Mesh size parameter 1/sqrt(nelem) (aoutput.cpp:53)."""
        return 1.0 / float(np.sqrt(self.n_cells))


def compile_mesh(md: MeshData, bcs: Sequence[BCSpec] = (),
                 pad_cells: int = 8, pad_faces: int = 8,
                 dtype=jnp.float64, validate: bool = True) -> CompiledMesh:
    """Compile raw mesh + BC spec into device arrays.

    validate=True (default) rejects degenerate input loudly (zero/negative
    areas, zero-length faces, NaN geometry) instead of emitting inf/NaN
    coefficient arrays — the reference's behaviour (ameshutils.cpp:127-151).
    """
    topo = build_topology(md)

    # periodic pairing mutates topo.f_cells right-cell entries
    for bc in bcs:
        if BC_NAMES.get(bc.type) == BC_PERIODIC:
            compute_periodic_map(topo, md.coords, bc.marker, bc.periodic_axis)

    geom = compute_geometry(md, topo)
    if validate:
        from .geometry import validate_geometry
        validate_geometry(md, geom, where="compile_mesh")

    nelem, nb, ni = topo.nelem, topo.nbface, topo.ninface
    nf = nb + ni
    NC = _round_up(max(nelem, 1), pad_cells)
    NF = _round_up(max(nf, 1), pad_faces)

    # ---- face arrays ----
    f_left = np.zeros(NF, np.int32)
    f_right = np.zeros(NF, np.int32)
    f_left[:nf] = topo.f_cells[:, 0]
    fr = topo.f_cells[:, 1].copy()
    fr[:nb] = np.where(fr[:nb] >= 0, fr[:nb], topo.f_cells[:nb, 0])
    f_right[:nf] = fr

    f_normal = np.zeros((NF, 2)); f_normal[:, 0] = 1.0
    f_normal[:nf] = geom.f_normal
    f_len = np.zeros(NF); f_len[:nf] = geom.f_len
    f_mid = np.zeros((NF, 2)); f_mid[:nf] = geom.f_mid
    f_rpoint = f_mid.copy()
    per = np.flatnonzero(topo.periodic_partner >= 0)
    if per.size:
        f_rpoint[per] = geom.f_mid[topo.periodic_partner[per]]

    f_rcl = np.zeros((NF, 2)); f_rcl[:nf] = geom.rc[topo.f_cells[:nf, 0]]
    f_rcr = np.zeros((NF, 2))
    f_rcr[:nb] = geom.rcbp                       # ghost centres (incl. periodic)
    if ni:
        f_rcr[nb:nf] = geom.rc[topo.f_cells[nb:nf, 1]]
    drv = f_rcr - f_rcl
    f_dist = np.sqrt((drv ** 2).sum(1))
    f_dist[nf:] = 1.0
    f_dist = np.where(f_dist == 0, 1.0, f_dist)
    f_dr_unit = drv / f_dist[:, None]

    # Green-Gauss inverse-distance interpolation weights from the face
    # midpoint to the two cell centres (agradientschemes.cpp:100-152)
    dl = np.sqrt(((f_mid - f_rcl) ** 2).sum(1))
    dr = np.sqrt(((f_mid - f_rcr) ** 2).sum(1))
    dl = np.where(dl == 0, 1.0, dl)
    dr = np.where(dr == 0, 1.0, dr)
    il, ir = 1.0 / dl, 1.0 / dr
    f_wl = il / (il + ir)
    f_wr = ir / (il + ir)
    f_wl[nf:] = 0.5; f_wr[nf:] = 0.5

    # least-squares weights (1/d^2) and directions (agradientschemes.cpp:243-310)
    f_dr = f_rcl - f_rcr
    d2 = (f_dr ** 2).sum(1)
    f_w2 = np.where(d2 > 0, 1.0 / np.where(d2 == 0, 1.0, d2), 0.0)
    f_w2[nf:] = 0.0

    # ---- cell arrays ----
    area = np.ones(NC); area[:nelem] = geom.area
    rc = np.zeros((NC, 2)); rc[:nelem] = geom.rc
    cell_mask = np.zeros(NC); cell_mask[:nelem] = 1.0
    clength = np.ones(NC); clength[:nelem] = geom.clength

    cell_faces = np.zeros((NC, MAXNF), np.int32)
    cell_fsign = np.zeros((NC, MAXNF))
    cell_nbrs = np.tile(np.arange(NC, dtype=np.int32)[:, None], (1, MAXNF))
    nbr_mask = np.zeros((NC, MAXNF))

    ef = topo.elemface  # (nelem, maxnfael)
    for k in range(ef.shape[1]):
        valid = ef[:, k] >= 0
        fidx = np.where(valid, ef[:, k], 0)
        isleft = topo.f_cells[fidx, 0] == np.arange(nelem)
        cell_faces[:nelem, k] = np.where(valid, fidx, 0)
        cell_fsign[:nelem, k] = np.where(valid, np.where(isleft, 1.0, -1.0), 0.0)
        nbr = np.where(isleft, topo.f_cells[fidx, 1], topo.f_cells[fidx, 0])
        is_phys_b = (fidx < nb) & valid
        # ghost slot for physical boundary neighbours: NC + bface index
        nbr = np.where(is_phys_b, NC + fidx, nbr)
        cell_nbrs[:nelem, k] = np.where(valid, nbr, np.arange(nelem))
        nbr_mask[:nelem, k] = np.where(valid & ~is_phys_b, 1.0, 0.0)

    # weighted-least-squares LHS: V[c] = sum_f w2 * dr dr^T over the cell's
    # faces, inverted once (agradientschemes.cpp:228-318)
    w2g = f_w2[cell_faces] * (cell_fsign != 0)          # (NC,4)
    drg = f_dr[cell_faces]                              # (NC,4,2)
    V = np.einsum("ck,cki,ckj->cij", w2g, drg, drg)
    # padded / degenerate cells: identity to keep inverses finite
    detV = V[:, 0, 0] * V[:, 1, 1] - V[:, 0, 1] * V[:, 1, 0]
    scale = (V[:, 0, 0] + V[:, 1, 1]) ** 2
    bad = ~(np.abs(detV) > 1e-10 * np.maximum(scale, 1e-30))
    V[bad] = np.eye(2)
    wls_vinv = np.linalg.inv(V)

    # ---- boundary conditions ----
    bc_code = np.zeros(max(nb, 1), np.int32)
    bc_v0 = np.zeros(max(nb, 1))
    bc_v1 = np.zeros(max(nb, 1))
    bc_tag = np.zeros(max(nb, 1), np.int32)
    if nb:
        bc_tag[:nb] = topo.btags[:, 0]
        marker_map = {bc.marker: bc for bc in bcs}
        for ib in range(nb):
            bc = marker_map.get(int(bc_tag[ib]))
            if bc is None:
                raise ValueError(f"no BC specified for marker {int(bc_tag[ib])}")
            bc_code[ib] = BC_NAMES[bc.type]
            if len(bc.values) > 0:
                bc_v0[ib] = bc.values[0]
            if len(bc.values) > 1:
                bc_v1[ib] = bc.values[1]

    color_rows, color_counts, n_colors = greedy_coloring(
        cell_nbrs, nbr_mask, cell_mask > 0, NC)

    sn, sdr, sdist, slen, scode, sv0, sv1 = build_slot_arrays(
        f_normal, f_dr_unit, f_dist, f_len, bc_code, bc_v0, bc_v1, nb,
        cell_faces, cell_fsign)

    fa = lambda x: jnp.asarray(x, dtype=dtype)
    ia = lambda x: jnp.asarray(x, dtype=jnp.int32)

    return CompiledMesh(
        f_left=ia(f_left), f_right=ia(f_right), f_normal=fa(f_normal),
        f_len=fa(f_len), f_mid=fa(f_mid), f_rpoint=fa(f_rpoint),
        f_rcl=fa(f_rcl), f_rcr=fa(f_rcr),
        f_dr_unit=fa(f_dr_unit), f_dist=fa(f_dist), f_wl=fa(f_wl),
        f_wr=fa(f_wr), f_w2=fa(f_w2), f_dr=fa(f_dr),
        area=fa(area), inv_area=fa(1.0 / area), rc=fa(rc),
        cell_mask=fa(cell_mask), cell_faces=ia(cell_faces),
        cell_fsign=fa(cell_fsign), cell_nbrs=ia(cell_nbrs),
        nbr_mask=fa(nbr_mask), wls_vinv=fa(wls_vinv), clength=fa(clength),
        color_rows=ia(color_rows), color_counts=ia(color_counts),
        slot_normal=fa(sn), slot_dr_unit=fa(sdr), slot_dist=fa(sdist),
        slot_len=fa(slen), slot_bc_code=ia(scode), slot_v0=fa(sv0),
        slot_v1=fa(sv1),
        bc_code=ia(bc_code), bc_v0=fa(bc_v0), bc_v1=fa(bc_v1), bc_tag=ia(bc_tag),
        n_cells=nelem, n_bfaces=nb, n_ifaces=ni, NC=NC, NF=NF,
        n_colors=n_colors,
    )
