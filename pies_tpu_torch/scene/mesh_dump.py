"""Imported tet meshes in the mesh-dump text format (port of
``scripts/prof_mesh.py:18-27``).

The format is the one ``scripts/dump_mesh.py`` writes and the reference's
own benchmark reads: a header line ``nodes tets surface_triangles``, then
the node positions, the tets' node ids and the surface triangles' node ids,
all whitespace-separated.  ``scripts/refbench/tet_cube_mesh.txt`` (1,331
nodes, 6,000 tets) and ``tet_cube_mesh_100k.txt`` (110,592 nodes, 622,938
tets) are committed dumps.
"""

from __future__ import annotations

import numpy as np


def load_mesh_txt(path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(points f32[n, 3], tets i32[t, 4], surface i32[s, 3])``, every
    number parsed as float64 first, as the reference's reader does."""
    with open(path) as f:
        nn, nt, ns = (int(v) for v in f.readline().split())
        flat = np.array(f.read().split(), dtype=np.float64)
    points = flat[: 3 * nn].reshape(nn, 3).astype(np.float32)
    tets = flat[3 * nn : 3 * nn + 4 * nt].reshape(nt, 4).astype(np.int32)
    surface = flat[3 * nn + 4 * nt :].reshape(ns, 3).astype(np.int32)
    return points, tets, surface


def add_tet_mesh(solver, points, tets, surface, w: float = 1000.0,
                 inv_mass: float = 1.0, radius: float = 0.2, pins=(),
                 pin_w: float = 8000.0) -> np.ndarray:
    """Add an imported mesh to ``solver`` as one body: its nodes, a strain
    and a volume constraint of weight ``w`` on every tet, and its surface
    triangles (floor contact and, later, self-contact); the mesh's nodes
    ``pins`` are held at their initial positions by position constraints of
    weight ``pin_w``.  Without pins, the scene of
    ``scripts/bench_all.py:116-121``.  Returns the nodes' global ids."""
    b = solver._builder
    ids = b._emit_nodes(points, inv_mass=inv_mass, radius=radius)
    b._emit_tets(ids[tets], w)
    b._emit_triangles(ids[surface])
    if len(pins):
        b.pos_idx.append(ids[np.asarray(pins)].astype(np.int32))
        b.pos_w.append(np.full(len(pins), pin_w, np.float32))
    solver._dirty = True
    solver.render_state_dirty = True
    return ids
