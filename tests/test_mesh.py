"""Mesh reader + topology + geometry tests.

Mirrors the reference topology self-consistency tests
(FVENS tests/mesh/mesh.cpp:16-185): intfac/esuel invariants, face-range
consistency, periodic pairing, plus closed-surface geometric identities
(sum of n*len over each cell's faces = 0, total area checks).
"""

import numpy as np
import pytest

from fvens_tpu.mesh import read_mesh, compile_mesh
from fvens_tpu.mesh.reader import MeshData
from fvens_tpu.mesh.topology import build_topology
from fvens_tpu.mesh.geometry import compute_geometry
from fvens_tpu.config import BCSpec


def unit_square_quads(n=4) -> MeshData:
    """Structured n x n quad mesh of the unit square, marker 1 everywhere."""
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    nid = lambda i, j: j * (n + 1) + i
    cells, bfaces = [], []
    for j in range(n):
        for i in range(n):
            cells.append(([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], []))
    for i in range(n):
        bfaces.append(([nid(i, 0), nid(i + 1, 0)], [1]))
        bfaces.append(([nid(i + 1, n), nid(i, n)], [1]))
        bfaces.append(([nid(0, i + 1), nid(0, i)], [1]))
        bfaces.append(([nid(n, i), nid(n, i + 1)], [1]))
    from fvens_tpu.mesh.reader import _assemble
    return _assemble(coords, cells, bfaces, nbtag=1, ndtag=0)


def check_invariants(md: MeshData):
    topo = build_topology(md)
    geom = compute_geometry(md, topo)

    assert topo.nbface == md.nbface
    # Euler-like count: every element face is either interior (shared) or boundary
    total_ef = int(md.nfael.sum())
    assert 2 * topo.ninface + topo.nbface == total_ef

    # all areas positive (CCW elements)
    assert np.all(geom.area > 0)

    # each interior face: left cell < right cell, normal points left->right
    fc = topo.f_cells[topo.nbface:]
    assert np.all(fc[:, 0] < fc[:, 1])
    d = geom.rc[fc[:, 1]] - geom.rc[fc[:, 0]]
    dots = (d * geom.f_normal[topo.nbface:]).sum(1)
    assert np.all(dots > 0), "interior normals must point from left to right"

    # boundary normals point away from the host cell centre
    fcb = topo.f_cells[: topo.nbface, 0]
    db = geom.f_mid[: topo.nbface] - geom.rc[fcb]
    assert np.all((db * geom.f_normal[: topo.nbface]).sum(1) > 0)

    # closed-cell identity: sum over each cell's faces of sign * n * len == 0
    nelem = md.nelem
    acc = np.zeros((nelem, 2))
    for k in range(topo.elemface.shape[1]):
        f = topo.elemface[:, k]
        valid = f >= 0
        fi = np.where(valid, f, 0)
        sign = np.where(topo.f_cells[fi, 0] == np.arange(nelem), 1.0, -1.0)
        w = np.where(valid, sign, 0.0)
        acc += w[:, None] * geom.f_normal[fi] * geom.f_len[fi, None]
    assert np.abs(acc).max() < 1e-12
    return topo, geom


def test_square_quads():
    md = unit_square_quads(5)
    topo, geom = check_invariants(md)
    assert abs(geom.area.sum() - 1.0) < 1e-14
    assert topo.ninface == 2 * 5 * 4


def test_reference_hybrid_mesh(refdir):
    md = read_mesh(str(refdir / "tests/common-input/testhybrid.msh"))
    check_invariants(md)
    # hybrid: both triangles and quads present
    assert set(np.unique(md.nnode)) == {3, 4}


def test_reference_cylinder_mesh(refdir):
    md = read_mesh(str(refdir / "testcases/2dcylinder/grids/2dcylinder0.msh"))
    topo, geom = check_invariants(md)
    # annulus area between r=1 and r=20 approximately
    approx = np.pi * (20.0 ** 2 - 1.0 ** 2)
    assert abs(geom.area.sum() - approx) / approx < 0.05


def test_reference_su2_mesh(refdir):
    md = read_mesh(str(refdir / "testcases/visc-naca0012/grids/NACA0012_lam_hybrid_1.su2"))
    check_invariants(md)


def test_periodic_pairing(refdir):
    md = read_mesh(str(refdir / "tests/common-input/testperiodic.msh"))
    from fvens_tpu.mesh.topology import compute_periodic_map
    topo = build_topology(md)
    # reference test uses marker 4 as the periodic boundary, axis 0
    # (tests/mesh/mesh.cpp Mesh_Periodic)
    for marker, axis in ((4, 0),):
        compute_periodic_map(topo, md.coords, marker, axis)
    sel = np.flatnonzero(topo.btags[:, 0] == 4)
    assert sel.size > 0
    assert np.all(topo.periodic_partner[sel] >= 0)
    # partner of partner is self
    pp = topo.periodic_partner
    assert np.all(pp[pp[sel]] == sel)
    # right cell set to partner's left cell
    assert np.all(topo.f_cells[sel, 1] == topo.f_cells[pp[sel], 0])


def test_compile_mesh_padding():
    md = unit_square_quads(3)   # 9 cells, 24 bfaces... 9 cells pad to 16
    cm = compile_mesh(md, [BCSpec(marker=1, type="farfield")])
    assert cm.NC % 8 == 0 and cm.NF % 8 == 0
    assert cm.n_cells == 9
    assert float(cm.cell_mask.sum()) == 9.0
    # every real cell has 4 signed faces
    sgn = np.asarray(cm.cell_fsign)[:9]
    assert np.all(np.abs(sgn).sum(axis=1) == 4)


def test_compile_mesh_rejects_degenerate_input():
    """compile_mesh/partition_mesh must die loudly on bad topology instead
    of emitting inf/NaN coefficient arrays (the reference's behaviour,
    ameshutils.cpp:127-151); this bug class once shipped a NaN-solve
    number from a large-mesh probe."""
    import dataclasses
    from fvens_tpu.dist.partition import partition_mesh
    from fvens_tpu.mesh.geometry import MeshValidationError

    good = unit_square_quads(3)
    compile_mesh(good, [BCSpec(marker=1, type="farfield")])  # sanity

    # collapse node 1 onto node 0: a zero-length face + zero-area cells
    bad_coords = good.coords.copy()
    bad_coords[1] = bad_coords[0]
    bad = dataclasses.replace(good, coords=bad_coords)
    with pytest.raises(MeshValidationError, match="zero"):
        compile_mesh(bad, [BCSpec(marker=1, type="farfield")])
    with pytest.raises(MeshValidationError, match="zero"):
        partition_mesh(bad, [BCSpec(marker=1, type="farfield")], 2)

    # NaN coordinates are rejected too
    nan_coords = good.coords.copy()
    nan_coords[2, 0] = np.nan
    bad2 = dataclasses.replace(good, coords=nan_coords)
    with pytest.raises(MeshValidationError, match="non-finite"):
        compile_mesh(bad2, [BCSpec(marker=1, type="farfield")])

    # the escape hatch still compiles (for deliberate-degenerate tests)
    cm = compile_mesh(bad, [BCSpec(marker=1, type="farfield")],
                      validate=False)
    assert cm.n_cells == 9
