"""The crossing nets of ``scripts/bench_all.py:221-291`` (the ``edge_nets``
cell), at any size, on either package's ``Solver``.

Two ``nn`` x ``nn`` wireframe nets of pitch 1.0: the bottom one at y = 1.2
with its corners pinned (w 8000), the top one at y = 1.45 turned by π/4, so
every strand of one crosses strands of the other.  Nodes have inverse mass
1 and radius 0.08; the strands are distance constraints (w 4000) and each
lattice cell is two triangles, which the edge-edge detection walks.  The
bench runs it with ``enable_edge_collisions=True``, ``reference_quirks=
False``, ``contact_coupling="full"`` and caps of 2,048 contacts
(:func:`solver_args`); ``nn`` is 24 there (1,152 nodes, 2,116
triangles) and 6 at its small size.  :func:`nets_ensemble` stacks the
port's nets into a seeded ensemble.
"""

from __future__ import annotations

import numpy as np

BENCH_NN = 24
BENCH_CAPS = 2048


def solver_args(caps: int = BENCH_CAPS) -> dict:
    """The bench's ``Solver`` arguments beside ``SolverOptions(solver=PD)``,
    with contact caps ``caps`` (both point-triangle and edge-edge)."""
    return dict(enable_collisions=True, enable_edge_collisions=True, reference_quirks=False,
                contact_coupling="full",
                budget_overrides=dict(max_point_tri_contacts=caps, max_edge_contacts=caps))


def _emit_net(s, nn: int, y: float, angle: float, pin_corners: bool) -> int:
    half = 0.5 * (nn - 1) * 1.0
    sx = np.linspace(-half, half, nn, dtype=np.float32)
    gx, gz = np.meshgrid(sx, sx, indexing="ij")
    c, si = np.cos(angle), np.sin(angle)
    px = c * gx - si * gz
    pz = si * gx + c * gz
    pts = np.stack([px, np.full_like(gx, y), pz], -1).reshape(-1, 3)
    ids = s._builder._emit_nodes(pts.astype(np.float32), inv_mass=1.0, radius=0.08)
    g = ids.reshape(nn, nn)
    pairs = np.concatenate([
        np.stack([g[:-1, :].ravel(), g[1:, :].ravel()], 1),
        np.stack([g[:, :-1].ravel(), g[:, 1:].ravel()], 1),
    ])
    s._builder._emit_distance(pairs, 4000.0)
    tris = np.concatenate([
        np.stack([g[:-1, :-1].ravel(), g[1:, :-1].ravel(), g[1:, 1:].ravel()], 1),
        np.stack([g[:-1, :-1].ravel(), g[1:, 1:].ravel(), g[:-1, 1:].ravel()], 1),
    ])
    s._builder._emit_triangles(tris)
    if pin_corners:
        corners = np.array([g[0, 0], g[0, -1], g[-1, 0], g[-1, -1]], np.int32)
        s._builder.pos_idx.append(corners)
        s._builder.pos_w.append(np.full(4, 8000.0, np.float32))
    return tris.shape[0]


def add_crossing_nets(s, nn: int = BENCH_NN):
    """The bench's two nets, the pinned one first; returns ``s``."""
    _emit_net(s, nn, 1.2, 0.0, pin_corners=True)
    _emit_net(s, nn, 1.45, np.pi / 4, pin_corners=False)
    s._dirty = True
    return s


def nets_ensemble(members: int, nn: int = BENCH_NN, device="cuda", seed0: int = 0,
                  **overrides):
    """A seeded ensemble of the crossing nets on the port: a ``Solver`` with
    :func:`solver_args` (``overrides`` replace its arguments) and
    :func:`add_crossing_nets` at ``nn``, prepared, and ``members`` copies of
    its state, member b's live nodes moved by
    ``contact_piles.jitter_offsets`` (uniform ±0.02, seed ``seed0 + b``;
    member 0 as built).  Returns ``(solver, states)``."""
    from ..options import SolverOptions
    from ..solver.host import Solver
    from .contact_piles import jittered_ensemble

    s = add_crossing_nets(Solver(SolverOptions(), device=device,
                                 **{**solver_args(), **overrides}), nn)
    s._prepare()
    return s, jittered_ensemble(s.state, members, s._builder.num_nodes, seed0=seed0)
