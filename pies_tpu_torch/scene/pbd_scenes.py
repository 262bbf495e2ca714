"""The PBD scenes of ``scripts/bench_all.py`` (the rope fleet and the node
pile), at any size, on either package's ``Solver``.

* :func:`add_rope_fleet` — ``rope_pbd`` (``bench_all.py:59-72``): ropes of
  128 nodes, ``w = 0.9``, pinned at their start; rope r starts at
  ``(0.5·(r mod 4), 8, 0.7·⌊r/4⌋)`` and runs 12 along x.  2,048 particles is
  the bench's size (16 ropes), 131,072 the same formula at 1,024 ropes.
* :func:`add_node_pile` — ``pbd_node_pile`` (``bench_all.py:168-175``):
  ``default_rng(3)``, uniform in ``[−h, h] × [0.5, 6] × [−h, h]``, added as
  bare nodes (node-node contact only).  ``h = 4`` at the bench's 8,192
  particles; by default ``h`` grows with the count so that the density, and
  so each grid cell's occupancy, stays the bench's (``h = 16`` at 131,072:
  16× the floor area).  :func:`cloud_ensemble` stacks it, under the PD
  solver with node-node contacts, into a seeded ensemble.
* :func:`rope_ensemble`, :func:`pile_ensemble` — seeded ensembles of the
  two PBD scenes as the bench runs them (collisions on), and
  :func:`pbd_ensemble` of any PBD scene.
* :func:`add_net` — the 8 x 8 PBD net of ``tests/test_solver.py:654-672``
  (distance constraints on a lattice, one corner pinned): the colour
  classes' scene.
"""

from __future__ import annotations

import numpy as np

ROPE_NODES = 128
PILE_BENCH = 8192


def add_rope_fleet(s, n_particles: int = 2048, w: float = 0.9):
    """``n_particles / 128`` ropes, as the bench builds them."""
    for r in range(n_particles // ROPE_NODES):
        start = (0.5 * (r % 4), 8.0, 0.7 * (r // 4))
        s.create_rope(start, (start[0] + 12.0, 8.0, start[2]), ROPE_NODES, w=w)
    return s


def pile_half_width(n_particles: int) -> float:
    """The half width of the pile's floor square at the bench's density."""
    return 4.0 * float(np.sqrt(n_particles / PILE_BENCH))


def add_node_pile(s, n_particles: int = PILE_BENCH, half: float | None = None):
    """``n_particles`` nodes uniform in the pile's box (seed 3)."""
    h = pile_half_width(n_particles) if half is None else half
    rng = np.random.default_rng(3)
    pts = rng.uniform([-h, 0.5, -h], [h, 6.0, h], (n_particles, 3)).astype(np.float32)
    s.add_nodes(pts)
    return s


def cloud_ensemble(members: int, n_particles: int = PILE_BENCH, device="cuda", seed0: int = 0,
                   **overrides):
    """A seeded ensemble of PD node clouds on the port: ``Solver(SolverOptions
    (solver=PD), enable_collisions=False, enable_node_collisions=True)``
    with a cap of ``16 · n_particles`` node-node contacts (``overrides``
    replace these arguments), :func:`add_node_pile`, prepared, and
    ``members`` copies of its state, member b's nodes moved by
    ``contact_piles.jitter_offsets`` (uniform ±0.02, seed ``seed0 + b``;
    member 0 as built).  Returns ``(solver, states)``."""
    from ..options import SolverName, SolverOptions
    from ..solver.host import Solver
    from .contact_piles import jittered_ensemble

    kw = dict(enable_collisions=False, enable_node_collisions=True,
              budget_overrides=dict(max_node_node_contacts=16 * n_particles))
    s = add_node_pile(Solver(SolverOptions(solver=SolverName.PD), device=device,
                             **{**kw, **overrides}), n_particles)
    s._prepare()
    return s, jittered_ensemble(s.state, members, n_particles, seed0=seed0)


def pbd_ensemble(build, members: int, device="cuda", seed0: int = 0, **solver_kw):
    """A seeded ensemble of a PBD scene on the port: ``Solver(SolverOptions
    (solver=PBD), **solver_kw)``, ``build(solver)``, prepared (the node-pair
    cache allocated with collisions on), and ``members`` copies of its
    state, member b's live nodes moved by ``contact_piles.jitter_offsets``
    (uniform ±0.02, seed ``seed0 + b``; member 0 as built).  Returns
    ``(solver, states)``."""
    from ..options import SolverName, SolverOptions
    from ..solver.host import Solver
    from .contact_piles import jittered_ensemble

    s = Solver(SolverOptions(solver=SolverName.PBD), device=device, **solver_kw)
    build(s)
    s._prepare()
    return s, jittered_ensemble(s.state, members, s._builder.num_nodes, seed0=seed0)


def rope_ensemble(members: int, n_particles: int = 2048, device="cuda", seed0: int = 0):
    """``members`` × ``rope_pbd`` (:func:`add_rope_fleet`, collisions on),
    seeded as :func:`pbd_ensemble`."""
    return pbd_ensemble(lambda s: add_rope_fleet(s, n_particles), members, device, seed0,
                        enable_collisions=True)


def pile_ensemble(members: int, n_particles: int = PILE_BENCH, device="cuda", seed0: int = 0):
    """``members`` × ``pbd_node_pile`` (:func:`add_node_pile`, collisions
    on), seeded as :func:`pbd_ensemble`."""
    return pbd_ensemble(lambda s: add_node_pile(s, n_particles), members, device, seed0,
                        enable_collisions=True)


def add_net(s, n: int = 8):
    """An ``n`` x ``n`` lattice of nodes 8 above the floor, its edges as
    distance constraints (w 0.9), node 0 pinned (w 1)."""
    sx = np.linspace(0.0, 4.0, n, dtype=np.float32)
    gx, gz = np.meshgrid(sx, sx, indexing="ij")
    pts = np.stack([gx, np.full_like(gx, 8.0), gz], -1).reshape(-1, 3)
    ids = s._builder._emit_nodes(pts, inv_mass=1.0, radius=0.1)
    g = ids.reshape(n, n)
    s._builder._emit_distance(np.concatenate([
        np.stack([g[:-1, :].ravel(), g[1:, :].ravel()], 1),
        np.stack([g[:, :-1].ravel(), g[:, 1:].ravel()], 1)]), 0.9)
    s._builder.pos_idx.append(ids[:1])
    s._builder.pos_w.append(np.full(1, 1.0, np.float32))
    s._dirty = True
    return s
