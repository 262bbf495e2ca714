"""Multi-scene ensembles on one card (port of
``pies_tpu/parallel/ensemble.py:34-122``, ROADMAP item 10a).

The JAX package steps a batch of independent scenes under ``jax.vmap`` of
its tick, with topology, parameters and configuration shared, and shards
the batch over a device mesh.  Here the batch is a member axis written out:
an ensemble is one ``SolverState`` whose every leaf has a leading axis B
(``state.stack_ensemble``), and the tet-column path's kernels T1-T8 take
that axis, so a tick of B scenes is the same launches as a tick of one.
``vmap``'s select of ``lax.cond``'s branches (``step.py:161``) is the
per-member latch: a member whose ``sim_failed`` is set is left bit for bit
as it is and reports residual 0, while the others step.

The ensemble runs on the tet-column path (``tetcols.applies``), with or
without self-contact in any detection branch (packed bodies, ROADMAP item
10a; the reference sweep and the cell list when the budget unpacks the
bodies, item 10c), and on the
generic PD path: contact-free (item 10b-i: the rope of
``tests/test_parallel.py``, the meshes, the cloth and its constraint
families, a soup off the tet-column path), where the kernels T9-T13 and
T22 take the member axis too and each member's CG leaves at its own trip,
as ``vmap`` of the JAX package's ``while_loop`` selects each member's carry
once its condition fails; and with point-triangle self-contact (item
10b-ii: ``tet_cube_drop`` with the bench's self-contact, the box piles) in
every detection branch (super-body T14/T15; all-pairs, cell list, per-body
and reference T16/T17), under recentered or full coupling (T7's force, or
T23's blocks) and on either floor (dense, or T24's entry list); and with
edge-edge and PD node-node contacts (item 10b-iii: ``edge_nets``, the PD
node clouds), alone, together or beside point-triangle self-contact, where
T16 and T25 detect each member's edge contacts, T26 adds their terms to
T8, T9 and T10, T20 builds each member's pair prefix and T27 adds the
pairs' terms and friction.  PBD ensembles run too (item 10b-iv: the
JAX package's vmapped PBD tick with every distance form, pins, strain,
bend and the node-node response), where T18, T19 and T21 take the member
axis and T20 keeps each member's node-pair cache across ticks, rebuilt on
that member's own drift.  :func:`ensemble_step` is the one-card form of
``make_sharded_step``'s step, its ``pmax`` and ``psum`` reductions over the
member axis on the device.

Over R ranks (ROADMAP item 11b; ``pies_tpu/parallel/ensemble.py:77-122``):
:func:`shard_ensemble` keeps the rank's contiguous B/R members on its
device (the mesh is :func:`.ranks.make_mesh`'s), :func:`make_sharded_step`
steps them with the kernels above and reduces the fleet's diagnostics over
the ranks (an ``all_reduce(MAX)`` of the residual, an ``all_reduce(SUM)``
of the latched count), and :func:`gather_ensemble` brings every member
back.  Members never exchange anything else.
"""

from __future__ import annotations

import torch

from dataclasses import fields, is_dataclass, replace

import torch.distributed as dist

from ..options import PhysicsParams, StepConfig
from ..solver import step
from ..state import SolverState, stack_ensemble, unstack
from ..topology import Topology
from .ranks import Mesh, Transport, make_mesh

__all__ = ["ensemble_step", "ensemble_tick", "ensemble_tick_n", "gather_ensemble", "make_mesh",
           "make_sharded_step", "shard_ensemble", "stack_ensemble", "unstack"]


def check_ensemble(states: SolverState) -> None:
    """Raise unless ``states`` is an ensemble (a leading member axis)."""
    if not states.members:
        raise ValueError("an ensemble's state has a leading member axis (stack_ensemble)")


def ensemble_tick(states: SolverState, topo: Topology, params: PhysicsParams,
                  config: StepConfig, counters=None) -> torch.Tensor:
    """One tick of every member, in place on ``states``; returns the
    residuals f32[B] on the device (0 for a latched member, and for every
    member of a PBD ensemble).  ``counters`` are ``pd.new_counters(device,
    B)``, or ``pbd.new_counters(device, B)`` under the PBD solver."""
    check_ensemble(states)
    return step.tick(states, topo, params, config, counters=counters)


def ensemble_tick_n(states: SolverState, topo: Topology, params: PhysicsParams,
                    config: StepConfig, n: int, counters=None) -> torch.Tensor:
    """``n`` ticks of every member with no host sync; returns the largest of
    the last tick's residuals over the members (``ensemble.py:70,73``), a
    device scalar."""
    check_ensemble(states)
    res = step.tick_n(states, topo, params, config, n, counters=counters)
    return torch.max(res)


def ensemble_step(states: SolverState, topo: Topology, params: PhysicsParams,
                  config: StepConfig, counters=None):
    """One tick of every member and the fleet's diagnostics, the one-card
    form of ``make_sharded_step``'s step (``ensemble.py:92-122``): returns
    ``(max_residual, num_failed)``, device scalars: the largest residual and
    the number of latched members after the tick."""
    res = ensemble_tick(states, topo, params, config, counters=counters)
    return torch.max(res), (states.sim_failed != 0).any(dim=-1).sum()


def _map(fn, obj):
    """``fn`` on every tensor of a state (its caches' too), field by field."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if is_dataclass(obj) and not isinstance(obj, type):
        return replace(obj, **{f.name: _map(fn, getattr(obj, f.name)) for f in fields(obj)})
    return obj


def shard_ensemble(states: SolverState, mesh: Mesh) -> SolverState:
    """This rank's contiguous B/R members of the ensemble ``states`` (every
    rank passes the same B members), copied to the mesh's device
    (``ensemble.py:86``); raises unless R divides B."""
    check_ensemble(states)
    mine = mesh.share(states.members, "members")
    return _map(lambda t: t[mine].to(mesh.device, copy=True).contiguous(), states)


def gather_ensemble(states: SolverState, mesh: Mesh) -> SolverState:
    """Every rank's members, gathered in rank order (each rank gets all B),
    on the mesh's device: :func:`shard_ensemble`'s inverse."""
    net = Transport(mesh)
    return _map(lambda t: net.gather(t.contiguous()), states)


def make_sharded_step(mesh: Mesh, config: StepConfig):
    """The ensemble step over the ranks (``ensemble.py:92-122``):
    ``step(states, topo, params) -> (states, max_residual, num_failed)``
    ticks this rank's members in place (:func:`ensemble_step`) and gives
    the fleet's largest residual (``all_reduce(MAX)``, the ``pmax``) and
    latched count (``all_reduce(SUM)``, the ``psum``), device scalars equal
    on every rank; ``step.transport`` is its :class:`.ranks.Transport`."""
    net = Transport(mesh)

    def sharded_step(states: SolverState, topo: Topology, params: PhysicsParams):
        res, failed = ensemble_step(states, topo, params, config)
        return (states, net.all_reduce_(res.reshape(1), dist.ReduceOp.MAX)[0],
                net.all_reduce_(failed.reshape(1))[0])

    sharded_step.transport = net
    return sharded_step
