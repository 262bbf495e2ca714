"""Small scenes in self-contact built from the reference's own primitives,
the ones that take the per-triangle detection branches (at most 1,024
triangles): a pile of ``create_box``es and a ``create_tet_box`` thrown onto
another.  Works on either package's ``Solver`` (it calls the public
builders only).  :func:`jittered_ensemble` stacks a prepared scene into an
ensemble whose members start a seeded jitter apart; :func:`branch_scene`
builds the port's small scenes of each detection branch and contact term.
"""

from __future__ import annotations

import numpy as np
import torch

JITTER = 0.02


def add_box_pile(s, n_boxes: int = 5, gap: float = 0.3):
    """``n_boxes`` ``create_box``es (5 × 5 × 5 distance lattices of side 4,
    192 surface triangles each: 960 for five, under the all-pairs limit of
    1,024) stacked with gaps of ``gap``, the lowest 0.02 over the floor,
    each staggered by (0.37, 0.23) in x and z so that no node lies on
    another box's lattice.  With the default gap the boxes touch from tick
    ~27, once the lowest rests on the floor."""
    for i in range(n_boxes):
        s.create_box((0.37 * i, 0.02 + (4.0 + gap) * i, 0.23 * i), 1.0, 1000.0)
    return s


def add_tet_boxes(s):
    """Two ``create_tet_box``es (3 × 3 × 3 lattices of side 2, 48 surface
    triangles each), the upper one 0.28 above the lower, staggered off its
    lattice and thrown down at 3 units/s: they touch from tick ~5."""
    s.create_tet_box((0.0, 0.02, 0.0), 1.0, (0.0, 0.0, 0.0), 1500.0, 1.0)
    s.create_tet_box((0.37, 2.3, 0.23), 1.0, (0.0, -3.0, 0.0), 1500.0, 1.0)
    return s


def jitter_offsets(members: int, live: int, jitter: float = JITTER,
                   seed0: int = 0) -> np.ndarray:
    """Each member's offset f32[members, live, 3] of its live nodes: a jitter
    uniform in ±``jitter`` per coordinate from the seed ``seed0 + b``;
    member 0 gets none."""
    off = np.zeros((members, live, 3), np.float32)
    for b in range(1, members):
        off[b] = np.random.default_rng(seed0 + b).uniform(-jitter, jitter, (live, 3))
    return off


def jittered_ensemble(state, members: int, live: int, jitter: float = JITTER,
                      seed0: int = 0):
    """``members`` copies of the prepared single scene ``state``, member b's
    first ``live`` nodes (positions and previous positions) moved by
    :func:`jitter_offsets`."""
    from ..state import stack_ensemble

    states = stack_ensemble(state, members)
    off = torch.from_numpy(jitter_offsets(members, live, jitter, seed0)).to(states.device)
    states.positions[:, :live] += off
    states.prev_positions[:, :live] += off
    return states


# The super-body layout switched off (``tests/test_collisions.py:784-805``).
SUPER_OFF = dict(super_k=0, super_packed_k=0, super_packed_m=0, super_packed_off=0,
                 super_live_k=0, super_faces=(), super_packed_e=0, super_loose_face=-1)
BRANCHES = ("allpairs", "super", "celllist", "reference", "bodies", "full_entry")


def branch_scene(kind: str, device="cuda"):
    """A small scene of the port's in self-contact that takes one detection
    branch or contact term (``kind`` of ``BRANCHES``): :func:`add_tet_boxes`
    (in contact from tick ~5) under the default all-pairs branch, the
    super-body layout (``allpairs_broadphase_max=0``), the cell list (that,
    with the super-body layout switched off), the reference sweep, or full
    coupling on the entry-list floor; or a 24-tet soup at spacing 1.0 off
    the tet-column path under the per-body cell list (``body_nodes = 0``;
    its tets meet from tick ~32); or (``"all_on"``) the tet boxes with
    edge-edge and node-node contacts on too (a cap of 4,096 pairs), all
    three families live from tick ~10.  Returns ``(solver, config)``, the
    solver prepared."""
    import dataclasses

    from ..options import SolverOptions
    from ..solver.host import Solver

    kw = dict(super=dict(allpairs_broadphase_max=0), celllist=dict(allpairs_broadphase_max=0),
              reference=dict(broadphase_mode="reference"),
              full_entry=dict(contact_coupling="full"),
              all_on=dict(enable_edge_collisions=True, enable_node_collisions=True,
                          budget_overrides=dict(max_node_node_contacts=4096))).get(kind, {})
    s = Solver(SolverOptions(), enable_collisions=True, device=device, **kw)
    if kind == "bodies":
        s.create_tet_soup(24, spacing=1.0, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
    else:
        add_tet_boxes(s)
    s._prepare()
    fields = dict(celllist=SUPER_OFF, full_entry=dict(dense_floor=False),
                  bodies=dict(body_nodes=0, body_node_offset=0, body_faces=(),
                              tet_cols=False)).get(kind, {})
    return s, dataclasses.replace(s.config, **fields)
