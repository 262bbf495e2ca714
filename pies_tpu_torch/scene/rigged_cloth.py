"""A rigged cloth: the scene that drives every constraint family of the
generic PD path but the tets.

An ``n × n`` lattice in the xz plane at ``y = height`` (``inv_mass`` 1, radius
``0.5·scale``), built on a solver's builder as ``scripts/bench_all.py:188-205``
builds its cloth: ``create_sheet``'s four distance families and
``create_bend_sheet``'s three bend families, two triangles per cell, all at
weight ``w``.  In place of ``create_bend_sheet``'s pins the first three
columns are one fixed region (``add_fixed_regions``: a goal group that
``update_fixed_regions`` can move), and an ``n/16 × n/16`` grid of boxes each
holding ``8 × 8`` nodes are linked regions (``add_linked_regions``: shape
groups over a quarter of the sheet), as a Maya rig drives a cloth.  The rest
of the sheet hangs from the fixed columns and swings down to the floor.

At ``n = 512``: 262,144 nodes, 1,045,506 distance pairs, 781,321 bends,
522,242 triangles, one goal group of 1,536 nodes and 1,024 shape groups of
64.  Works on either package's ``Solver`` (it uses the builder's lists and
the two region calls only).
"""

from __future__ import annotations

import numpy as np

from .builder import _sheet_tris, sheet_bends, sheet_distance_pairs

_F32 = np.float32


def _box(center, half) -> np.ndarray:
    """The 4x4 matrix of the region box ``center ± half``."""
    m = np.eye(4, dtype=_F32)
    m[:3, :3] = np.diag(np.asarray(half, _F32))
    m[:3, 3] = np.asarray(center, _F32)
    return m


def fixed_region_matrix(n: int, scale: float, height: float, angle: float = 0.0) -> np.ndarray:
    """The fixed region: a box over columns 0..2 of the lattice, turned by
    ``angle`` (radians) about the lattice's first column (the line x = 0,
    y = height).  ``angle = 0`` is the matrix the region is created with;
    another angle is what ``update_fixed_regions`` takes."""
    span = 0.5 * (n - 1) * scale
    box = _box((scale, height, span), (1.25 * scale, 0.5, span + 0.25 * scale))
    c, s = np.cos(angle), np.sin(angle)
    turn = np.eye(4, dtype=_F32)
    turn[:2, :2] = [[c, -s], [s, c]]
    turn[:2, 3] = [s * height, height - c * height]  # keeps (0, height, z) in place
    return (turn @ box).astype(_F32)


def linked_region_matrices(n: int, scale: float, height: float) -> list[np.ndarray]:
    """The linked regions: for every 16 × 16 block of lattice cells, a box
    over its nodes 4..11 in both directions."""
    per_side = n // 16
    half = (3.75 * scale, 0.5, 3.75 * scale)
    return [
        _box(((16 * a + 7.5) * scale, height, (16 * b + 7.5) * scale), half)
        for a in range(per_side) for b in range(per_side)
    ]


def add_rigged_cloth(solver, n: int = 512, scale: float = 0.1, height: float = 0.3,
                     w: float = 5000.0) -> np.ndarray:
    """Add the rigged cloth to ``solver``; returns its nodes' global ids
    (``ids.reshape(n, n)[i, j]`` is lattice node (i, j), at ``(scale·i,
    height, scale·j)``)."""
    b = solver._builder
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pos = np.stack([scale * i, np.full(i.shape, height), scale * j], axis=-1)
    ids = b._emit_nodes(pos.reshape(-1, 3).astype(_F32), inv_mass=1.0, radius=0.5 * scale)
    gid = ids.reshape(n, n)
    b._emit_distance(np.concatenate(sheet_distance_pairs(gid), axis=0), w)
    bends = sheet_bends(gid)
    b.bend_idx.append(bends)
    b.bend_w.append(np.full(bends.shape[0], w, _F32))
    b._emit_triangles(_sheet_tris(gid))
    solver.add_fixed_regions([fixed_region_matrix(n, scale, height)], w)
    solver.add_linked_regions(linked_region_matrices(n, scale, height), w)
    return ids
