"""Carry a JAX package run across to the port.

The PBD pieces come along: the rope chains, the node-pair cache (with the
port's incidence built from its prefix), the hinge toggle and the distance
form of the configuration.

The JAX package's ``SolverState``, ``Topology``, ``StepConfig`` and
``PhysicsParams`` come in with NumPy leaves (for example after
``jax.tree.map(np.asarray, ...)``) and leave as the port's dataclasses of
tensors on a chosen device.  Fields are read by name, so this module imports
nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .options import CollisionBudget, PhysicsParams, SolverName, StepConfig
from .state import BroadphaseCache, NodePairCache, SolverState, pair_incidence, stack_members
from .topology import (
    BendBatch,
    ChainBatch,
    DistanceBatch,
    GroupBatch,
    PositionBatch,
    TetBatch,
    Topology,
    corner_incidence,
    generic_fields,
    pbd_incidences,
    to_device,
)


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def cache_from_numpy(bp, device="cpu") -> BroadphaseCache | None:
    """The port's broadphase cache from a JAX ``BroadphaseCache`` with NumPy
    leaves: bools become int32, and pair slots past a row's valid prefix
    become 0 (the JAX package leaves sort leftovers there; nothing reads
    them).  A vmapped ensemble's cache (a leading member axis on every
    leaf) becomes the port's batched cache, ``fresh`` i32[B, 1]."""
    if bp is None:
        return None
    valid = np.asarray(bp.valid)
    fresh = np.asarray(bp.fresh)
    i32 = torch.int32
    return BroadphaseCache(
        pairs=_t(np.where(valid, np.asarray(bp.pairs), 0), device, i32),
        valid=_t(valid, device, i32),
        ref=_t(bp.ref, device),
        fresh=_t(fresh.reshape(fresh.shape + (1,)), device, i32),
        rebuilt=torch.zeros(fresh.shape + (1,), dtype=i32, device=device),
    )


def node_cache_from_numpy(nn, device="cpu") -> NodePairCache | None:
    """The port's node-pair cache from a JAX ``NodePairCache`` with NumPy
    leaves: scalars become i32[1], and the port's incidence is built from
    the pair prefix.  A vmapped ensemble's cache (``count`` i32[B], ``ref``
    f32[B, N, 3]) becomes the port's batched cache, each member's
    incidence built from its own prefix."""
    if nn is None:
        return None
    count = np.asarray(nn.count)
    if count.ndim:
        return stack_members([node_cache_from_numpy(type(nn)(**{
            f: np.asarray(getattr(nn, f))[b] for f in ("pi", "pj", "count", "ref", "fresh")}),
            device) for b in range(count.shape[0])])
    i32 = torch.int32
    pi, pj = _t(nn.pi, device, i32), _t(nn.pj, device, i32)
    count = int(count)
    row_off, inc_start, inc_pair = pair_incidence(pi, pj, count, np.asarray(nn.ref).shape[0])
    return NodePairCache(pi=pi, pj=pj, count=_t(np.reshape(count, 1), device, i32),
                         ref=_t(nn.ref, device),
                         fresh=_t(np.asarray(nn.fresh).reshape(1), device, i32),
                         row_off=row_off, inc_start=inc_start, inc_pair=inc_pair,
                         rebuilt=torch.zeros(1, dtype=i32, device=device))


def state_from_numpy(state, device="cpu") -> SolverState:
    """The port's state from a JAX ``SolverState`` with NumPy leaves.  Its
    scalar ``sim_failed`` becomes latch slot 0.  A vmapped ensemble (a
    leading member axis on every leaf, ``sim_failed`` bool[B]) becomes the
    port's batched state, latch i32[B, 2]."""
    latch = np.asarray(state.sim_failed)
    failed = torch.zeros(latch.shape + (2,), dtype=torch.int32, device=device)
    failed[..., 0] = torch.from_numpy(latch.astype(np.int32))
    return SolverState(
        positions=_t(state.positions, device),
        prev_positions=_t(state.prev_positions, device),
        velocities=_t(state.velocities, device),
        forces=_t(state.forces, device),
        inv_mass=_t(state.inv_mass, device),
        mass=_t(state.mass, device),
        radius=_t(state.radius, device),
        node_mask=_t(state.node_mask, device),
        sim_failed=failed,
        bp=cache_from_numpy(getattr(state, "bp", None), device),
        shape_quats=_t(state.shape_quats, device),
        nn=node_cache_from_numpy(getattr(state, "nn", None), device),
    )


def groups_from_numpy(g) -> GroupBatch:
    """The port's group batch from a JAX ``GroupBatch`` with NumPy leaves
    (the goal transforms included); the member runs are read off
    ``group_idx``, which ``build_groups`` fills group after group."""
    mask = np.asarray(g.member_mask) > 0
    counts = np.bincount(np.asarray(g.group_idx)[mask], minlength=g.w.shape[0])
    start = np.zeros(counts.shape[0] + 1, np.int32)
    np.cumsum(counts, out=start[1:])
    return GroupBatch(
        node_idx=g.node_idx, group_idx=g.group_idx, mat_coords=g.mat_coords,
        member_mask=g.member_mask, w=g.w, group_mask=g.group_mask, inv_count=g.inv_count,
        qinv=g.qinv, transforms=g.transforms, member_start=start,
        max_count=int(counts.max()) if counts.size else 0,
    )


def topology_from_numpy(topo, device="cpu", tet_fused: bool = True) -> Topology:
    """The port's topology from a JAX ``Topology`` with NumPy leaves (the
    ported fields only), for a scene with the JAX ``StepConfig.tet_fused``
    given.  The static weight, the assembled operator, the row incidence,
    the corner incidence and the PBD families' incidences are built here as
    the port's host builds them; the rope chains are the JAX package's; a banded
    soup's seven diagonals ``tet_band`` and the super-body tables
    ``super_corners`` and ``super_adj`` are the JAX arrays."""

    def tets(b):
        return TetBatch(idx=np.asarray(b.idx), qinv=np.asarray(b.qinv), g=np.asarray(b.g),
                        lo=np.asarray(b.lo), hi=np.asarray(b.hi), w=np.asarray(b.w))

    p, d, b = topo.position, topo.distance, topo.bend
    n = np.asarray(topo.stiffness_diag).shape[0]
    strain, volume = tets(topo.strain), tets(topo.volume)
    position = PositionBatch(idx=p.idx, target=p.target, w=p.w)
    distance = DistanceBatch(idx=np.asarray(d.idx), rest=np.asarray(d.rest), w=np.asarray(d.w))
    bend = BendBatch(idx=np.asarray(b.idx), rest_angle=np.asarray(b.rest_angle),
                     w=np.asarray(b.w))
    shape, goal = groups_from_numpy(topo.shape), groups_from_numpy(topo.goal)
    generic = generic_fields(n, strain=strain, volume=volume, position=position,
                             distance=distance, bend=bend, shape=shape, goal=goal,
                             tet_fused=tet_fused)
    if "tet_band" in generic:  # (the JAX package has one for every scene)
        generic["tet_band"] = np.asarray(topo.tet_band)
    opt = lambda a: None if a is None else np.asarray(a)
    ch = getattr(topo, "chains", None)
    chains = None if ch is None else ChainBatch(
        idx0=np.asarray(ch.idx0), anchor=np.asarray(ch.anchor), rest=np.asarray(ch.rest),
        w=np.asarray(ch.w))
    out = Topology(
            strain=strain,
            volume=volume,
            position=position,
            stiffness_diag=topo.stiffness_diag,
            floor_count=topo.floor_count,
            tet_block6=topo.tet_block6,
            position_force_dense=topo.position_force_dense,
            triangles=topo.triangles,
            tri_mask=topo.tri_mask,
            **generic,
            corner_inc=(corner_incidence(n, np.asarray(topo.triangles))
                        if np.asarray(topo.triangles).shape[0] else None),
            super_corners=opt(getattr(topo, "super_corners", None)),
            super_adj=opt(getattr(topo, "super_adj", None)),
            distance=distance,
            bend=bend,
            shape=shape,
            goal=goal,
            tet_fused=tet_fused,
            chains=chains,
        )
    out.jacobi = pbd_incidences(n, out)
    return to_device(out, device)


def config_from(config) -> StepConfig:
    """The port's ``StepConfig`` from a JAX one: the shared fields by name."""
    kw = {f.name: getattr(config, f.name) for f in dataclasses.fields(StepConfig)}
    kw["solver"] = SolverName(config.solver.value)
    kw["budget"] = CollisionBudget(
        **{f.name: getattr(config.budget, f.name)
           for f in dataclasses.fields(CollisionBudget)}
    )
    return StepConfig(**kw)


def params_from(params) -> PhysicsParams:
    """The port's ``PhysicsParams`` from a JAX one (scalar leaves)."""
    return PhysicsParams(
        **{f.name: float(np.asarray(getattr(params, f.name)))
           for f in dataclasses.fields(PhysicsParams)}
    )


def domain_host(dom):
    """The JAX package's ``Domain`` (its leaves NumPy, or anything
    ``np.asarray`` takes) as the port's host arrays, read by their field
    paths, and its geometry: ``(host, DomainMeta)``, NumPy and ints only, so
    that they cross to processes that import no JAX."""
    from .parallel.domain import DomainMeta, host_keys

    def leaf(path):
        obj = dom
        for name in path.split("."):
            obj = getattr(obj, name)
        return np.asarray(obj)

    m = dom.meta
    meta = DomainMeta(n_slabs=int(m.n_slabs), block=int(m.block), halo=int(m.halo))
    return {k: leaf(k) for k in host_keys()}, meta


def domain_from_numpy(dom, device="cpu", mesh=None):
    """The port's ``parallel.domain.Domain`` from the JAX package's
    ``Domain``: :func:`domain_host`'s arrays, then the port's tensors and
    flat view topology on ``device``; with ``mesh`` (a
    ``parallel.ranks.Mesh``) only the rank's slabs, on its device
    (``domain.shard_host``).  So both packages can start from one partition
    (:func:`domain_state_to_numpy` is the way back)."""
    from .parallel.domain import domain_from_host, shard_host

    host, meta = domain_host(dom)
    if mesh is not None:
        return shard_host(host, meta, mesh)
    return domain_from_host(host, meta, device)


def ensemble_from_numpy(states, device="cpu", mesh=None) -> SolverState:
    """The port's batched state from a JAX ensemble (a vmapped
    ``SolverState`` with NumPy leaves, :func:`state_from_numpy`); with
    ``mesh`` only the rank's contiguous B/R members, on its device
    (``parallel.ensemble.shard_ensemble``; raises unless R divides B)."""
    if mesh is None:
        return state_from_numpy(states, device)
    from .parallel.ensemble import shard_ensemble

    return shard_ensemble(state_from_numpy(states), mesh)


def domain_state_to_numpy(dstate) -> dict[str, np.ndarray]:
    """A port ``DomainState``'s arrays as the JAX ``DomainState``'s leaves,
    by field name: f32[D, L, 3] nodes, f32[D, G, 4] rotations, and the
    latch as bool[D] (the port's one latch, on every slab)."""
    f = lambda a: a.detach().cpu().numpy()  # noqa: E731
    return dict(positions=f(dstate.positions), prev_positions=f(dstate.prev_positions),
                velocities=f(dstate.velocities), shape_quats=f(dstate.shape_quats),
                sim_failed=dstate.failed_slabs())
