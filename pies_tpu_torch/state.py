"""Simulation state as a dataclass of tensors (port of ``pies_tpu/state.py``).

Structure-of-arrays with a padded node count, as in the JAX package:

* ``positions / prev_positions / velocities / forces``: ``f32[N, 3]``
* ``inv_mass / mass / radius / node_mask``: ``f32[N]``
* ``shape_quats``: ``f32[G, 4]`` (w, x, y, z), the shape-matching groups'
  rotations carried from tick to tick (the reference's persistent
  ``_currentRotation`` warm start); ``max(1, groups)`` rows, identity-seeded
* ``sim_failed``: ``i32[2]``, the ``_simFailed`` latch (``Solver.h:198``)
  kept on the device so that stepping never waits for the host.  Slot 0 holds
  the latch as of the start of the current tick; slot 1 is where a substep's
  tail ORs a new failure.  The first substep of each tick folds slot 1 into
  slot 0, so no kernel ever reads a word that another thread of the same
  launch may write.  The state has failed when either slot is non-zero.

Padded nodes are parked far away with ``inv_mass = 0``, ``mass = 1`` and
``node_mask = 0``, exactly as in the JAX package.

``bp`` is the temporal cache of the packed-body or the super-body broadphase
(``BroadphaseCache``), allocated by the host for self-contact scenes and
updated in place by the detection each substep.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PARK_BASE = 1.0e5  # world-space offset of the padding parking line
PARK_PITCH = 64.0  # spacing between parked particles


@dataclass
class BroadphaseCache:
    """Temporal broadphase cache (port of ``pies_tpu/state.py:41-60``).

    The candidate body pairs stay valid while no body node has moved more
    than ``PhysicsParams.broadphase_slack`` (per axis) from ``ref``: the build
    inflates every AABB by that slack, and the narrowphase re-tests the
    cached pairs at the current positions each substep.  ``valid`` and
    ``fresh`` are int32 0/1 (the kernels take int32); slots past a row's
    valid prefix hold 0.
    """

    pairs: torch.Tensor  # i32[K, NB] candidate bodies per body
    valid: torch.Tensor  # i32[K, NB] prefix mask
    # f32[K·m, 3] body-node positions at the last build (packed bodies), or
    # f32[N, 3], all nodes (the super-body layout).
    ref: torch.Tensor
    fresh: torch.Tensor  # i32[1]; 0 forces a rebuild

    def clone(self) -> "BroadphaseCache":
        return BroadphaseCache(self.pairs.clone(), self.valid.clone(),
                               self.ref.clone(), self.fresh.clone())


def empty_broadphase_cache(k: int, nb: int, m: int,
                           device: torch.device | str = "cpu") -> BroadphaseCache:
    """Unpopulated cache (``fresh = 0``: the first detection rebuilds)."""
    return BroadphaseCache(
        pairs=torch.zeros((k, nb), dtype=torch.int32, device=device),
        valid=torch.zeros((k, nb), dtype=torch.int32, device=device),
        ref=torch.zeros((m, 3), dtype=torch.float32, device=device),
        fresh=torch.zeros(1, dtype=torch.int32, device=device),
    )


@dataclass
class SolverState:
    positions: torch.Tensor  # f32[N, 3]
    prev_positions: torch.Tensor  # f32[N, 3]
    velocities: torch.Tensor  # f32[N, 3]
    forces: torch.Tensor  # f32[N, 3]
    inv_mass: torch.Tensor  # f32[N]
    mass: torch.Tensor  # f32[N]
    radius: torch.Tensor  # f32[N]
    node_mask: torch.Tensor  # f32[N]
    sim_failed: torch.Tensor  # i32[2], see the module docstring
    bp: BroadphaseCache | None = None
    shape_quats: torch.Tensor | None = None  # f32[G, 4]

    @property
    def capacity(self) -> int:
        return self.positions.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def failed(self) -> bool:
        """Host read of the latch (waits for the device)."""
        return bool(self.sim_failed.any().item())


def park_positions(num_padded: int, offset: int = 0) -> np.ndarray:
    """Distinct far-away positions for padded particles."""
    idx = np.arange(num_padded, dtype=np.float32) + float(offset)
    park = np.zeros((num_padded, 3), dtype=np.float32)
    park[:, 0] = PARK_BASE + PARK_PITCH * idx
    park[:, 1] = PARK_BASE
    return park


def make_state(
    positions: np.ndarray,
    *,
    velocities: np.ndarray | None = None,
    inv_mass: np.ndarray | None = None,
    radius: np.ndarray | None = None,
    capacity: int | None = None,
    device: torch.device | str = "cpu",
    num_shape_groups: int = 1,
) -> SolverState:
    """Build a padded state from host arrays and move it to ``device`` once.

    ``capacity`` defaults to the node count rounded up to a multiple of 8, as
    in the JAX package.
    """
    positions = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
    n = positions.shape[0]
    if capacity is None:
        capacity = max(8, -(-n // 8) * 8)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < particle count {n}")
    pad = capacity - n

    if velocities is None:
        velocities = np.zeros_like(positions)
    if inv_mass is None:
        inv_mass = np.ones(n, dtype=np.float32)
    if radius is None:
        radius = np.full(n, 0.5, dtype=np.float32)
    velocities = np.asarray(velocities, dtype=np.float32).reshape(-1, 3)
    inv_mass = np.asarray(inv_mass, dtype=np.float32).reshape(-1)
    radius = np.asarray(radius, dtype=np.float32).reshape(-1)

    pos_full = np.concatenate([positions, park_positions(pad)], axis=0)
    vel_full = np.concatenate([velocities, np.zeros((pad, 3), np.float32)])
    inv_mass_full = np.concatenate([inv_mass, np.zeros(pad, np.float32)])
    # Padded nodes get mass 1 so the PD system diagonal stays positive
    # definite; their solution is exactly their park position.
    with np.errstate(divide="ignore"):
        mass_live = np.where(inv_mass > 0, 1.0 / np.maximum(inv_mass, 1e-30), 0.0)
    mass_full = np.concatenate([mass_live.astype(np.float32), np.ones(pad, np.float32)])
    radius_full = np.concatenate([radius, np.zeros(pad, np.float32)])
    mask_full = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])

    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return SolverState(
        positions=dev(pos_full),
        prev_positions=dev(pos_full),
        velocities=dev(vel_full),
        forces=dev(np.zeros((capacity, 3), np.float32)),
        inv_mass=dev(inv_mass_full),
        mass=dev(mass_full),
        radius=dev(radius_full),
        node_mask=dev(mask_full),
        sim_failed=torch.zeros(2, dtype=torch.int32, device=device),
        shape_quats=dev(np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32),
                                (max(1, num_shape_groups), 1))),
    )
