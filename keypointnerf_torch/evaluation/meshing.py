"""Iso-surface mesh extraction (marching tetrahedra) + OBJ export.

The port's own copy of `keypointnerf_tpu/evaluation/meshing.py` (numpy;
the port imports nothing of the JAX package). It meshes the occupancy
grids of `models/keypoint_icon.py`: each grid cube is split into 6
tetrahedra and the 0.5-isosurface is triangulated per-tet (16 cases,
linear edge interpolation). Marching tetrahedra produces a consistent,
crack-free surface with far smaller case tables than marching cubes.

Host-side numpy, as the JAX package's is: mesh extraction is a
postprocess of the grid the card computes. It materialises (C, 8, 3)
corner indices for every cell of the grid (C = (res - 1)^3), ~1.5 GB at
a 256^3 grid.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# corner offsets (x, y, z) for ids 0..7
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    dtype=np.int32,
)
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    dtype=np.int32,
)


def _interp(p1, p2, v1, v2, iso):
    t = (iso - v1) / np.where(np.abs(v2 - v1) < 1e-12, 1e-12, v2 - v1)
    t = np.clip(t, 0.0, 1.0)[..., None]
    return p1 + t * (p2 - p1)


def marching_tetrahedra(
    values: np.ndarray, axes, iso: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a dense scalar grid.

    Args:
      values: (Nx, Ny, Nz) scalar field (occupancy in [0, 1]).
      axes:   3 arrays of coordinates along each grid axis.
      iso:    iso value.
    Returns:
      (vertices (M, 3) float32, faces (F, 3) int32). Vertices are not
      deduplicated (triangle soup) — adequate for Chamfer/P2S and OBJ
      export; watertight by construction per shared tet faces.
    """
    vals = np.asarray(values, np.float64)
    ax = [np.asarray(a, np.float64) for a in axes]
    nx, ny, nz = vals.shape

    # cube corner values/positions for all cells at once
    cx, cy, cz = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
    )
    cells = np.stack([cx, cy, cz], -1).reshape(-1, 3)  # (C, 3)

    corner_idx = cells[:, None, :] + _CORNERS[None, :, :]  # (C, 8, 3)
    cvals = vals[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    cpos = np.stack(
        [ax[0][corner_idx[..., 0]], ax[1][corner_idx[..., 1]], ax[2][corner_idx[..., 2]]],
        axis=-1,
    )  # (C, 8, 3)

    # prune cells fully inside/outside
    keep = ~(np.all(cvals < iso, 1) | np.all(cvals >= iso, 1))
    cvals, cpos = cvals[keep], cpos[keep]

    tris = []
    for tet in _TETS:
        tv = cvals[:, tet]            # (C', 4)
        tp = cpos[:, tet]             # (C', 4, 3)
        inside = tv >= iso            # (C', 4)
        code = (
            inside[:, 0].astype(int)
            + 2 * inside[:, 1]
            + 4 * inside[:, 2]
            + 8 * inside[:, 3]
        )

        def edge(sel, a, b):
            return _interp(
                tp[sel, a], tp[sel, b], tv[sel, a, None][:, 0], tv[sel, b, None][:, 0], iso
            )

        # single-corner cases (one vertex on one side): one triangle
        for corner, others, flip in (
            (0, (1, 2, 3), False), (1, (0, 3, 2), False),
            (2, (0, 1, 3), False), (3, (0, 2, 1), False),
        ):
            for c_in, want in ((1 << corner, True), (0b1111 ^ (1 << corner), False)):
                sel = code == c_in
                if not np.any(sel):
                    continue
                p0 = edge(sel, corner, others[0])
                p1 = edge(sel, corner, others[1])
                p2 = edge(sel, corner, others[2])
                tris.append(np.stack([p0, p1, p2], 1))

        # two-corner cases: quad -> two triangles
        for pair, opp in (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2))):
            for c_in in (
                (1 << pair[0]) | (1 << pair[1]),
                (1 << opp[0]) | (1 << opp[1]),
            ):
                sel = code == c_in
                if not np.any(sel):
                    continue
                a, b = pair if c_in == ((1 << pair[0]) | (1 << pair[1])) else opp
                c, d = opp if (a, b) == pair else pair
                e_ac = edge(sel, a, c)
                e_ad = edge(sel, a, d)
                e_bc = edge(sel, b, c)
                e_bd = edge(sel, b, d)
                tris.append(np.stack([e_ac, e_ad, e_bd], 1))
                tris.append(np.stack([e_ac, e_bd, e_bc], 1))

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    soup = np.concatenate(tris, 0).astype(np.float32)  # (F, 3, 3)
    verts = soup.reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return verts, faces


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    """Write a Wavefront OBJ."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def extract_mesh(occ, axes, iso: float = 0.5, path: str | None = None):
    """Convenience: occupancy grid -> (verts, faces), optional OBJ dump."""
    verts, faces = marching_tetrahedra(occ, axes, iso)
    if path is not None and len(verts):
        save_obj(path, verts, faces)
    return verts, faces
