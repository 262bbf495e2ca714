"""``tet_cube_drop`` (``scripts/bench_all.py:80-102``) and an ensemble of it
with a seeded lift per member.

The scene: the bench's cube, side 2 with its bottom at y = 0.5, meshed by
:func:`scene.tetmesh.tetrahedralize` at ``resolution`` cells across (10:
1,331 nodes, 6,000 tets), radius 0.2, strain and volume weight 1000.  With
self-contact off (``enable_collisions=False``) it takes the generic PD path
without contact terms; the floor acts on its surface triangles' corners.

:func:`lifted_ensemble` stacks a prepared scene's state ``members`` times
and raises member b's live nodes by its own lift, uniform in [0, 0.5] in y,
plus a jitter uniform in ±0.02 per coordinate (seed b; member 0 as built),
so the members reach the floor on different ticks and their CG solves
leave at different trips: the Monte-Carlo sweep of a drop test's initial
conditions in one process.
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import SolverState, stack_ensemble
from .tetmesh import tetrahedralize

CUBE_VERTS = np.array([[0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0],
                       [0, 0, 2], [2, 0, 2], [2, 2, 2], [0, 2, 2]], np.float32) \
    + np.array([0.0, 0.5, 0.0], np.float32)
CUBE_TRIS = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                      [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]],
                     np.int32)
MAX_LIFT, JITTER = 0.5, 0.02


def add_cube_drop(s, resolution: int = 10) -> np.ndarray:
    """Mesh the cube and add it to the solver ``s`` (either package's) as
    ``bench_all.py`` does; returns the node ids."""
    points, tets, surface = tetrahedralize(CUBE_VERTS, CUBE_TRIS, resolution)
    ids = s._builder._emit_nodes(points, inv_mass=1.0, radius=0.2)
    s._builder._emit_tets(ids[tets], 1000.0)
    s._builder._emit_triangles(ids[surface])
    s._dirty = True
    return ids


def member_offsets(members: int, live: int) -> np.ndarray:
    """Each member's offset f32[members, live, 3] of its live nodes: a lift
    uniform in [0, MAX_LIFT] in y and a jitter uniform in ±JITTER per
    coordinate, from the seed b; member 0 gets none."""
    out = np.zeros((members, live, 3), np.float32)
    for b in range(1, members):
        rng = np.random.default_rng(b)
        lift = np.float32(rng.uniform(0.0, MAX_LIFT))
        out[b] = rng.uniform(-JITTER, JITTER, (live, 3)).astype(np.float32)
        out[b, :, 1] += lift
    return out


def lifted_ensemble(state: SolverState, members: int, live: int) -> SolverState:
    """``members`` copies of the prepared single scene ``state``, member b's
    first ``live`` nodes (positions and previous positions) moved by
    :func:`member_offsets`."""
    states = stack_ensemble(state, members)
    off = torch.from_numpy(member_offsets(members, live)).to(states.device)
    states.positions[:, :live] += off
    states.prev_positions[:, :live] += off
    return states
