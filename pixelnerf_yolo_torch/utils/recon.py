"""Mesh reconstruction from a density grid: marching + OBJ export.

Counterpart of pixelnerf_yolo_tpu/utils/recon.py: ``marching_cubes`` and
``save_obj`` are copies of its numpy code (PyMCubes when it imports, else a
dependency-free marching-tetrahedra implementation), and
``extract_mesh_from_model`` evaluates the port's model.
"""

from __future__ import annotations

import numpy as np

try:
    import mcubes as _mcubes
except ImportError:  # pragma: no cover
    _mcubes = None

# 6-tetrahedra decomposition of a cube (corner indices)
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ]
)
# cube corner offsets (z, y, x)
_CORNERS = np.array(
    [
        [0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
        [1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0],
    ]
)


def _marching_tetrahedra(grid: np.ndarray, iso: float):
    """Vectorized marching tetrahedra over a dense scalar grid.

    :return (verts (V, 3) in grid coords (x, y, z), tris (T, 3) int)
    """
    nz, ny, nx = grid.shape
    # cell origins
    cz, cy, cx = np.meshgrid(
        np.arange(nz - 1), np.arange(ny - 1), np.arange(nx - 1), indexing="ij"
    )
    cells = np.stack([cz.ravel(), cy.ravel(), cx.ravel()], 1)  # (C, 3)

    corner_pos = cells[:, None, :] + _CORNERS[None]  # (C, 8, 3)
    vals = grid[
        corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]
    ]  # (C, 8)

    verts_list = []
    tris_list = []
    n_verts = 0

    for tet in _TETS:
        tv = vals[:, tet]  # (C, 4)
        tp = corner_pos[:, tet, :].astype(np.float64)  # (C, 4, 3)
        inside = tv > iso  # (C, 4)
        code = (
            inside[:, 0] * 1 + inside[:, 1] * 2 + inside[:, 2] * 4
            + inside[:, 3] * 8
        )

        # edge interpolation helper over selected cells
        def interp(sel, a, b):
            va, vb = tv[sel, a], tv[sel, b]
            t = (iso - va) / np.where(vb - va == 0, 1e-12, vb - va)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return tp[sel, a] * (1 - t) + tp[sel, b] * t

        # single-corner cases (1 triangle) and their complements
        single = {1: 0, 2: 1, 4: 2, 8: 3}
        for c_in, corner in single.items():
            for cc in (c_in, 15 - c_in):
                sel = np.nonzero(code == cc)[0]
                if len(sel) == 0:
                    continue
                others = [i for i in range(4) if i != corner]
                v0 = interp(sel, corner, others[0])
                v1 = interp(sel, corner, others[1])
                v2 = interp(sel, corner, others[2])
                tri_v = np.stack([v0, v1, v2], axis=1)  # (S, 3, 3)
                if cc != c_in:  # complement: flip winding
                    tri_v = tri_v[:, ::-1]
                verts_list.append(tri_v.reshape(-1, 3))
                idx = n_verts + np.arange(len(sel) * 3).reshape(-1, 3)
                tris_list.append(idx)
                n_verts += len(sel) * 3

        # two-corner cases (quad -> 2 triangles)
        pairs = {3: (0, 1), 5: (0, 2), 9: (0, 3), 6: (1, 2), 10: (1, 3),
                 12: (2, 3)}
        for cc, (a, b) in pairs.items():
            sel = np.nonzero(code == cc)[0]
            if len(sel) == 0:
                continue
            others = [i for i in range(4) if i not in (a, b)]
            va0 = interp(sel, a, others[0])
            va1 = interp(sel, a, others[1])
            vb0 = interp(sel, b, others[0])
            vb1 = interp(sel, b, others[1])
            quad1 = np.stack([va0, vb0, vb1], axis=1)
            quad2 = np.stack([va0, vb1, va1], axis=1)
            tri_v = np.concatenate([quad1, quad2], axis=0).reshape(-1, 3)
            verts_list.append(tri_v)
            idx = n_verts + np.arange(len(sel) * 6).reshape(-1, 3)
            tris_list.append(idx)
            n_verts += len(sel) * 6

    if not verts_list:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    verts = np.concatenate(verts_list, 0)
    tris = np.concatenate(tris_list, 0)
    # deduplicate vertices
    verts_r = np.round(verts, 6)
    uniq, inv = np.unique(verts_r, axis=0, return_inverse=True)
    tris = inv[tris]
    # grid coords come out (z, y, x): flip to (x, y, z) like mcubes
    return uniq[:, ::-1].copy(), tris


def marching_cubes(
    sigmas: np.ndarray,
    iso_value: float = 50.0,
    viz_std: float = 1.0,
    clean: bool = True,
):
    """Extract an isosurface mesh from a sigma grid.

    :param sigmas (D, H, W) density grid
    :return (vertices (V, 3), triangles (T, 3))
    (The reference's smoothing and largest-component cleaning are
    approximated by vertex dedup.)
    """
    sigmas = np.asarray(sigmas, dtype=np.float64)
    if _mcubes is not None:
        if clean:
            sigmas = _mcubes.smooth(sigmas > iso_value).astype(np.float64)
            iso = 0.0
        else:
            iso = iso_value
        return _mcubes.marching_cubes(sigmas, iso)
    return _marching_tetrahedra(sigmas, iso_value)


def save_obj(vertices, triangles, path, vert_rgb=None):
    """Write a Wavefront OBJ."""
    with open(path, "w") as f:
        for i, v in enumerate(vertices):
            if vert_rgb is not None:
                c = vert_rgb[i]
                f.write(
                    "v {} {} {} {} {} {}\n".format(
                        v[0], v[1], v[2], c[0], c[1], c[2]
                    )
                )
            else:
                f.write("v {} {} {}\n".format(v[0], v[1], v[2]))
        for t in triangles:
            f.write(
                "f {} {} {}\n".format(t[0] + 1, t[1] + 1, t[2] + 1)
            )


def extract_mesh_from_model(
    model,
    cond,
    bounds=((-1, 1), (-1, 1), (-1, 1)),
    resolution: int = 64,
    iso_value: float = 10.0,
    chunk: int = 65536,
):
    """Evaluate the field's sigma on a dense grid (viewdirs -z) and run
    marching cubes.

    :param model a port PixelNeRF in NeRF mode; cond its ``encode`` result
    :return (vertices (V, 3), triangles (T, 3))
    """
    import torch

    axes = [np.linspace(lo, hi, resolution) for lo, hi in bounds]
    zz, yy, xx = np.meshgrid(*axes[::-1], indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1).astype(np.float32)
    dirs = np.zeros_like(pts)
    dirs[:, 2] = -1.0
    dev = model.device
    sigmas = []
    with torch.no_grad():
        for start in range(0, len(pts), chunk):
            p = torch.from_numpy(pts[start:start + chunk][None]).to(dev)
            d = torch.from_numpy(dirs[start:start + chunk][None]).to(dev)
            out = model.forward(cond, p, viewdirs=d)
            sigmas.append(out[0, :, 3].float().cpu().numpy())
    grid = np.concatenate(sigmas).reshape(resolution, resolution, resolution)
    return marching_cubes(grid, iso_value=iso_value)
