"""Host-side mesh geometry: areas, centres, face metrics, ghost centres.

Matches the reference conventions exactly (FVENS src/mesh/mesh.cpp):
  - cell area by the shoelace formula for triangles and quads (:291-313),
  - cell centre = arithmetic mean of corner nodes (:317-328),
  - face normal (nx, ny) = (y2-y1, -(x2-x1)) normalized, plus length (:346-365)
    (points out of the left cell by construction of the face node order),
  - physical-boundary ghost-cell centre mirrored about the face midpoint
    (src/spatial/aspatial.cpp:98-119),
  - face quadrature point = face midpoint (NGAUSS=1, aspatial.cpp:51-61).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .reader import MeshData
from .topology import Topology


class MeshValidationError(ValueError):
    """Raised by validate_geometry on degenerate/corrupt mesh input."""


def validate_geometry(md: MeshData, geom: "Geometry", where: str = "mesh"
                      ) -> None:
    """Die loudly on bad topology/geometry, like the reference's checks and
    DEBUG asserts (mesh.cpp sanity checks, ameshutils.cpp:127-151).

    Rejects: non-finite node coordinates, zero/negative cell areas,
    zero-length faces, and any non-finite derived geometry (normals, cell
    centres, ghost centres). Without this, downstream kernels silently
    produce inf/NaN (inv_area, unit normals) and a solve can "run" on
    garbage — the class of bug behind an early large-mesh probe that
    reported a throughput for a NaN solve."""
    msgs = []
    if not np.isfinite(md.coords).all():
        msgs.append(f"{int((~np.isfinite(md.coords)).any(1).sum())} "
                    "non-finite node coordinates")
    bad_area = ~(geom.area > 0.0)          # catches NaN too
    if bad_area.any():
        i = int(np.flatnonzero(bad_area)[0])
        msgs.append(f"{int(bad_area.sum())} zero/negative-area cells "
                    f"(first: cell {i}, area {geom.area[i]:.3e})")
    bad_face = ~(geom.f_len > 0.0)
    if bad_face.any():
        i = int(np.flatnonzero(bad_face)[0])
        msgs.append(f"{int(bad_face.sum())} zero-length faces "
                    f"(first: face {i})")
    for name in ("rc", "f_normal", "f_mid", "rcbp", "clength"):
        arr = getattr(geom, name)
        if arr.size and not np.isfinite(arr).all():
            msgs.append(f"non-finite values in {name}")
    if msgs:
        raise MeshValidationError(
            f"{where}: degenerate mesh rejected — " + "; ".join(msgs)
            + ". The reference dies on such input (ameshutils.cpp:127-151);"
            " fix the generator/reader (e.g. geometric stretching that"
            " collapses below float spacing, scripts/bench_bigmesh.py:75).")


@dataclasses.dataclass
class Geometry:
    area: np.ndarray        # (nelem,)
    rc: np.ndarray          # (nelem, 2) cell centres
    f_normal: np.ndarray    # (naface, 2) unit normals, left -> right
    f_len: np.ndarray       # (naface,)
    f_mid: np.ndarray       # (naface, 2) face midpoints (quadrature points)
    rcbp: np.ndarray        # (nbface, 2) ghost-cell centres (midpoint mirror)
    clength: np.ndarray     # (nelem,) max edge length (Venkatakrishnan)


def compute_geometry(md: MeshData, topo: Topology) -> Geometry:
    coords = md.coords
    inpoel = md.inpoel
    nelem = md.nelem

    x = np.where(inpoel >= 0, coords[np.maximum(inpoel, 0), 0], 0.0)
    y = np.where(inpoel >= 0, coords[np.maximum(inpoel, 0), 1], 0.0)

    tri = md.nnode == 3

    def tri_area(x0, y0, x1, y1, x2, y2):
        return 0.5 * (x0 * (y1 - y2) - y0 * (x1 - x2) + x1 * y2 - x2 * y1)

    area = tri_area(x[:, 0], y[:, 0], x[:, 1], y[:, 1], x[:, 2], y[:, 2])
    if inpoel.shape[1] >= 4:
        quad_extra = tri_area(x[:, 0], y[:, 0], x[:, 2], y[:, 2], x[:, 3], y[:, 3])
        area = area + np.where(tri, 0.0, quad_extra)

    nn = md.nnode.astype(np.float64)
    mask = (inpoel >= 0).astype(np.float64)
    rc = np.stack([(x * mask).sum(1) / nn, (y * mask).sum(1) / nn], axis=1)

    p0 = coords[topo.f_nodes[:, 0]]
    p1 = coords[topo.f_nodes[:, 1]]
    nx = p1[:, 1] - p0[:, 1]
    ny = -(p1[:, 0] - p0[:, 0])
    flen = np.sqrt(nx * nx + ny * ny)
    with np.errstate(invalid="ignore", divide="ignore"):
        # zero-length faces yield NaN normals here; validate_geometry
        # rejects such meshes loudly before they reach any kernel
        f_normal = np.stack([nx / flen, ny / flen], axis=1)
    f_mid = 0.5 * (p0 + p1)

    nb = topo.nbface
    rcbp = 2.0 * f_mid[:nb] - rc[topo.f_cells[:nb, 0]] if nb else np.empty((0, 2))

    # characteristic length: max edge length over the element's edges
    # (limitedlinearreconstruction.cpp:185-200)
    clength = np.zeros(nelem)
    maxnn = inpoel.shape[1]
    rows = np.arange(nelem)
    for k in range(maxnn):
        valid = k < md.nnode
        nxt = (k + 1) % np.maximum(md.nnode, 1)
        i0 = np.maximum(inpoel[:, k], 0)
        i1 = np.maximum(inpoel[rows, nxt], 0)
        ll = np.sqrt(((coords[i0] - coords[i1]) ** 2).sum(1))
        clength = np.where(valid, np.maximum(clength, ll), clength)

    return Geometry(area=area, rc=rc, f_normal=f_normal, f_len=flen,
                    f_mid=f_mid, rcbp=rcbp, clength=clength)
