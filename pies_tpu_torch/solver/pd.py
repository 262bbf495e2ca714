"""Projective Dynamics substep on the tet-column path (port of
``pies_tpu/solver/pd.py:59-130,316-435,589-617``).

One substep is four launches on the card, each with a plain PyTorch twin:

* T3 :func:`substep_head` — inertia estimate, floor detection on the
  predicted positions, the system diagonal and the floor weight;
* T1 ``tet_force12`` — the first PD iteration's tet force;
* T2 ``tetcols.substep_cols`` — the PD iterations with the direct 4x4 block
  solve, the stale static projection and the residual;
* T4 :func:`substep_tail` — floor snap, velocity, floor friction, the state
  update and the failure latch, in place on the state.

The JAX tail's ``lax.cond(any_contact, …)`` is not needed: with no node
active the snap and the friction are identities, so both branches agree.
Point-triangle stabilization and friction are exact no-ops without
point-triangle contacts and come with the self-contact port.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..collision.batches import (
    CollisionSet,
    detect_floor_active,
    floor_plane,
    floor_threshold,
)
from ..constraints.projections import tet_force12, tet_force12_plain
from ..options import PhysicsParams, StepConfig
from ..state import SolverState
from ..topology import Topology
from . import assembly, tetcols


def _h_h2(params: PhysicsParams) -> tuple[float, float]:
    """``h`` and ``h·h`` as the float32 values the JAX package computes."""
    h = np.float32(params.dt)
    return float(h), float(h * h)


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    """``a / s`` as an IEEE division on every device.  (PyTorch's CUDA path
    turns division by a Python scalar into a product with its reciprocal,
    which rounds differently from the kernels and the JAX package.)"""
    return a / torch.full((), s, dtype=a.dtype, device=a.device)


def _fold_latch(failed: torch.Tensor) -> None:
    """First substep of a tick: slot 0 takes slot 1 (see state.py)."""
    failed[0:1].bitwise_or_(failed[1:2])


def check_detection(config: StepConfig) -> None:
    """Raise for the detection branches that are not ported yet."""
    if config.enable_collisions:
        raise NotImplementedError(
            "self-contact (point-triangle detection) is ROADMAP queue 1 item 3"
        )
    if not config.dense_floor:
        raise NotImplementedError("the floor entry-list path is ROADMAP queue 1 item 5")


def default_detect_collisions(x: torch.Tensor, topo: Topology,
                              params: PhysicsParams, config: StepConfig) -> CollisionSet:
    """PD collision detection for one substep, dense-floor branch with
    self-contact off (``pies_tpu/solver/step.py:26-44``)."""
    check_detection(config)
    return CollisionSet(
        floor_active=detect_floor_active(x, topo.floor_count, floor_threshold(params))
    )


def substep_head_plain(state: SolverState, topo: Topology, params: PhysicsParams,
                       config: StepConfig, fold: bool):
    """Plain twin of kernel T3.  Returns ``(x, msn_h2, diag, wf, active)``:
    the predicted positions and ``M·x/h²`` f32[N, 3], the system diagonal, the
    floor weight ``W_STATIC·count·active`` and the floor activity f32[N]."""
    if fold:
        _fold_latch(state.sim_failed)
    h, h2 = _h_h2(params)
    mask = state.node_mask[:, None]
    # Inertia estimate sₙ = q + h·v and Msₙ/h² (Solver.cpp:229-238).
    x = state.positions + h * state.velocities * mask
    mass_over_h2 = _div(state.mass, h2)
    msn_h2 = x * mass_over_h2[:, None]
    colls = default_detect_collisions(x, topo, params, config)
    diag = assembly.system_diag(mass_over_h2, topo, colls)
    wf = assembly.static_collision_diag(colls, topo.floor_count)
    return x, msn_h2, diag, wf, colls.floor_active


def substep_head(state: SolverState, topo: Topology, params: PhysicsParams,
                 config: StepConfig, fold: bool):
    """Kernel T3 on a CUDA state, :func:`substep_head_plain` on a CPU state.
    ``fold`` marks the first substep of a tick (the latch fold)."""
    pos = state.positions
    if kernels.on_cpu(pos):
        return substep_head_plain(state, topo, params, config, fold)
    check_detection(config)  # the kernel fuses the dense-floor detection
    n = state.capacity
    kernels.require(pos.device, pos, state.velocities, state.mass, state.node_mask,
                    topo.floor_count, topo.stiffness_diag, state.sim_failed)
    x = torch.empty_like(pos)
    msn = torch.empty_like(pos)
    diag, wf, active = (torch.empty(n, dtype=torch.float32, device=pos.device)
                        for _ in range(3))
    h, h2 = _h_h2(params)
    err = kernels.lib().pies_substep_head(
        pos.data_ptr(), state.velocities.data_ptr(), state.mass.data_ptr(),
        state.node_mask.data_ptr(), topo.floor_count.data_ptr(),
        topo.stiffness_diag.data_ptr(), x.data_ptr(), msn.data_ptr(),
        diag.data_ptr(), wf.data_ptr(), active.data_ptr(), n, h, h2,
        floor_threshold(params), state.sim_failed.data_ptr(), int(fold),
        kernels.stream(),
    )
    kernels.check(err, "substep_head")
    substep_head.launches += 1
    return x, msn, diag, wf, active


substep_head.launches = 0


def _static_floor_friction(vel: torch.Tensor, colls: CollisionSet,
                           params: PhysicsParams, floor_count: torch.Tensor) -> torch.Tensor:
    """Floor friction (``Solver.cpp:473-484``): a node hit by k floor entries
    decays its xz velocity by ``(1−f)^k``, the static threshold evaluated at
    the velocity before the pass (FIDELITY.md)."""
    counts = floor_count * colls.floor_active
    norm = torch.sqrt(vel[:, 0] * vel[:, 0] + vel[:, 2] * vel[:, 2])
    static = norm < params.static_friction_threshold
    keep = float(np.float32(1.0) - np.float32(params.friction))
    factor = torch.where(static, 0.0, torch.pow(keep, counts))
    factor = torch.where(counts > 0, factor, 1.0)
    out = vel.clone()
    out[:, 0] = vel[:, 0] * factor
    out[:, 2] = vel[:, 2] * factor
    return out


def substep_tail_plain(state: SolverState, topo: Topology, params: PhysicsParams,
                       active: torch.Tensor, x: torch.Tensor,
                       static_proj: torch.Tensor) -> None:
    """Plain twin of kernel T4 — ``pd._finish_substep`` on the dense floor
    without point-triangle contacts — in place on ``state``: floor snap,
    velocity, floor friction, ``positions = prev = x``, gravity forces, and
    the OR of non-finite positions into latch slot 1.  Nothing changes when
    latch slot 0 is set (a skipped tick)."""
    colls = CollisionSet(floor_active=active)
    h, _ = _h_h2(params)
    mask = state.node_mask[:, None]
    # Hard snap of floor contacts to the stale static projection
    # (Solver.cpp:379-382).
    x = torch.where(colls.floor_active[:, None] > 0, static_proj, x)
    gy = (-params.gravity * state.mass) * state.node_mask
    forces = torch.zeros_like(x)
    forces[:, 1] = gy
    keep = float(np.float32(1.0) - np.float32(params.damping))
    vel = (_div(keep * (x - state.prev_positions), h)
           + h * forces * state.inv_mass[:, None]) * mask
    vel = _static_floor_friction(vel, colls, params, topo.floor_count)

    skip = state.sim_failed[0] != 0
    for old, new in ((state.positions, x), (state.prev_positions, x),
                     (state.velocities, vel), (state.forces, forces)):
        old.copy_(torch.where(skip, old, new))
    bad = ~torch.isfinite(x).all() & ~skip
    state.sim_failed[1:2].bitwise_or_(bad.to(torch.int32))


def substep_tail(state: SolverState, topo: Topology, params: PhysicsParams,
                 active: torch.Tensor, x: torch.Tensor,
                 static_proj: torch.Tensor) -> None:
    """Kernel T4 on a CUDA state, :func:`substep_tail_plain` on a CPU state."""
    pos = state.positions
    if kernels.on_cpu(pos):
        return substep_tail_plain(state, topo, params, active, x, static_proj)
    kernels.require(pos.device, pos, state.prev_positions, state.velocities,
                    state.forces, x, static_proj, active, topo.floor_count,
                    state.inv_mass, state.mass, state.node_mask, state.sim_failed)
    h, _ = _h_h2(params)
    err = kernels.lib().pies_substep_tail(
        pos.data_ptr(), state.prev_positions.data_ptr(),
        state.velocities.data_ptr(), state.forces.data_ptr(), x.data_ptr(),
        static_proj.data_ptr(), active.data_ptr(), topo.floor_count.data_ptr(),
        state.inv_mass.data_ptr(), state.mass.data_ptr(),
        state.node_mask.data_ptr(), state.capacity, h, params.damping,
        params.gravity, params.friction, params.static_friction_threshold,
        state.sim_failed.data_ptr(), kernels.stream(),
    )
    kernels.check(err, "substep_tail")
    substep_tail.launches += 1


substep_tail.launches = 0


def pd_substep(state: SolverState, topo: Topology, params: PhysicsParams,
               config: StepConfig, fold: bool, plain: bool = False) -> torch.Tensor:
    """One PD substep on the tet-column path, in place on ``state``; returns
    the device-side residual ``‖b − A·x‖`` of its last iteration.

    ``plain=True`` runs the plain twins whatever the device (the card's
    reference run); otherwise each wrapper picks the kernel for a CUDA state
    and the twin for a CPU state."""
    head, force, cols, tail = (
        (substep_head_plain, tet_force12_plain, tetcols.substep_cols_plain,
         substep_tail_plain)
        if plain else (substep_head, tet_force12, tetcols.substep_cols, substep_tail)
    )
    x, msn_h2, diag, wf, active = head(state, topo, params, config, fold)
    f0 = force(x, topo.strain, topo.volume, state.sim_failed) if config.iterations else None
    x_new, static_proj, r2 = cols(
        x, msn_h2, diag, state.node_mask, wf, f0, topo,
        floor_plane(params, config.reference_quirks), config.iterations,
        state.sim_failed,
    )
    tail(state, topo, params, active, x_new, static_proj)
    return torch.sqrt(torch.sum(r2))
