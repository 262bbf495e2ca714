"""Carry a JAX package run across to the port.

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
from .state import BroadphaseCache, SolverState
from .topology import (
    PositionBatch,
    TetBatch,
    Topology,
    pin_weights,
    tet_incidence,
    to_device,
)


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def cache_from_numpy(bp, device="cpu") -> BroadphaseCache | None:
    """The port's broadphase cache from a JAX ``BroadphaseCache`` with NumPy
    leaves: bools become int32, and pair slots past a row's valid prefix
    become 0 (the JAX package leaves sort leftovers there; nothing reads
    them)."""
    if bp is None:
        return None
    valid = np.asarray(bp.valid)
    i32 = torch.int32
    return BroadphaseCache(
        pairs=_t(np.where(valid, np.asarray(bp.pairs), 0), device, i32),
        valid=_t(valid, device, i32),
        ref=_t(bp.ref, device),
        fresh=_t(np.asarray(bp.fresh).reshape(1), device, i32),
    )


def state_from_numpy(state, device="cpu") -> SolverState:
    """The port's state from a JAX ``SolverState`` with NumPy leaves.  Its
    scalar ``sim_failed`` becomes latch slot 0."""
    failed = torch.zeros(2, dtype=torch.int32, device=device)
    failed[0] = int(bool(np.asarray(state.sim_failed)))
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
    )


def topology_from_numpy(topo, device="cpu") -> Topology:
    """The port's topology from a JAX ``Topology`` with NumPy leaves (the
    ported fields only).  The ELL operator becomes slot-major; the pin
    weight and, with the ELL, the tet incidence are built here as the
    port's host builds them."""

    def tets(b):
        return TetBatch(idx=b.idx, qinv=b.qinv, g=b.g, lo=b.lo, hi=b.hi, w=b.w)

    def slot_major(a):
        return None if a is None else np.ascontiguousarray(np.asarray(a).T)

    p = topo.position
    n = np.asarray(topo.stiffness_diag).shape[0]
    ell = getattr(topo, "ell_nbr", None)
    return to_device(
        Topology(
            strain=tets(topo.strain),
            volume=tets(topo.volume),
            position=PositionBatch(idx=p.idx, target=p.target, w=p.w),
            stiffness_diag=topo.stiffness_diag,
            floor_count=topo.floor_count,
            tet_block6=topo.tet_block6,
            position_force_dense=topo.position_force_dense,
            triangles=topo.triangles,
            tri_mask=topo.tri_mask,
            pin_w=pin_weights(p, n),
            ell_nbr=slot_major(ell),
            ell_coef=slot_major(getattr(topo, "ell_coef", None)),
            tet_inc=None if ell is None else tet_incidence(np.asarray(topo.strain.idx), n),
        ),
        device,
    )


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
