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
updated in place by the detection each substep.  ``nn`` is the PBD
node-pair cache (``NodePairCache``), allocated by the host for PBD scenes
with collisions on and updated in place by the node-node response.

:func:`save_state` and :func:`load_state` write and read the JAX package's
checkpoint: an npz of the state's leaves in the JAX package's pytree order,
so either package loads the other's file.

An ensemble (``pies_tpu/parallel/ensemble.py``) is one ``SolverState`` whose
every leaf has a leading member axis B, the cache's included:
``positions`` f32[B, N, 3], ``mass`` f32[B, N], ``sim_failed`` i32[B, 2]
(each row the two-slot latch above), ``bp.pairs`` i32[B, K, NB], ``bp.ref``
f32[B, M, 3], ``bp.fresh`` i32[B, 1], ``nn.pi`` i32[B, NB], ``nn.count``
i32[B, 1].  One-word flags and counts keep a unit
axis, so member b's slice (:func:`member`) of any batched value is the
single scene's value, a view that shares its memory.
:func:`stack_ensemble` makes one, :func:`unstack` copies one member out.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass, replace

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
    # i32[1]: 1 when the last packed-body broadphase on this cache rebuilt
    # the pairs (kernel T5 and its twin write it; not part of a checkpoint)
    rebuilt: torch.Tensor

    def clone(self) -> "BroadphaseCache":
        return BroadphaseCache(self.pairs.clone(), self.valid.clone(),
                               self.ref.clone(), self.fresh.clone(), self.rebuilt.clone())


def empty_broadphase_cache(k: int, nb: int, m: int,
                           device: torch.device | str = "cpu") -> BroadphaseCache:
    """Unpopulated cache (``fresh = 0``: the first detection rebuilds)."""
    return BroadphaseCache(
        pairs=torch.zeros((k, nb), dtype=torch.int32, device=device),
        valid=torch.zeros((k, nb), dtype=torch.int32, device=device),
        ref=torch.zeros((m, 3), dtype=torch.float32, device=device),
        fresh=torch.zeros(1, dtype=torch.int32, device=device),
        rebuilt=torch.zeros(1, dtype=torch.int32, device=device),
    )


@dataclass
class NodePairCache:
    """Temporal node-pair cache of the PBD response (port of
    ``pies_tpu/state.py:65-92``).

    The pair list is rebuilt only when the cache is stale or some node has
    moved more than ``collision.broadphase.NN_CACHE_SLACK`` (per axis) from
    ``ref``; the reference's AABB padding of 0.5 keeps the cached list a
    superset of every touching set until then, and the response re-tests
    each pair at the current positions.  ``pi``/``pj`` hold the live pairs
    as a prefix of ``count``, i-major, each row's j ascending.

    The port's own fields: the per-node incidence of the pair list's
    entries ``concat(pi, pj)`` that the response sums over, built at each
    rebuild (:func:`pair_incidence`), and the rebuild flag of the last
    response (a device word the host never waits on)."""

    pi: torch.Tensor  # i32[NB]
    pj: torch.Tensor  # i32[NB]
    count: torch.Tensor  # i32[1] live prefix length
    ref: torch.Tensor  # f32[N, 3] positions at the last build
    fresh: torch.Tensor  # i32[1]; 0 forces a rebuild
    # Node n is the i of pairs row_off[n] .. row_off[n+1]-1, and the j of
    # pairs inc_pair[inc_start[n] .. inc_start[n+1]-1] (ascending).
    row_off: torch.Tensor  # i32[N + 1]
    inc_start: torch.Tensor  # i32[N + 1]
    inc_pair: torch.Tensor  # i32[NB]
    rebuilt: torch.Tensor  # i32[1]

    def clone(self) -> "NodePairCache":
        return NodePairCache(*(getattr(self, f.name).clone() for f in fields(self)))


def empty_node_pair_cache(n: int, bwidth: int,
                          device: torch.device | str = "cpu") -> NodePairCache:
    """Unpopulated node-pair cache (``fresh = 0``: the first use rebuilds)."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    return NodePairCache(pi=z(n * bwidth), pj=z(n * bwidth), count=z(1),
                         ref=torch.zeros((n, 3), dtype=torch.float32, device=device),
                         fresh=z(1), row_off=z(n + 1), inc_start=z(n + 1),
                         inc_pair=z(n * bwidth), rebuilt=z(1))


def pair_incidence(pi: torch.Tensor, pj: torch.Tensor, count: int, n: int):
    """``(row_off, inc_start, inc_pair)`` of a pair prefix (see
    ``NodePairCache``): node n's entries of ``concat(pi, pj)`` are its pairs
    as i, then its pairs as j in ascending pair order, which is the order
    the JAX package's scatter over ``concat(pi, pj)`` adds them in."""
    dev = pi.device
    ci = torch.bincount(pi[:count].long(), minlength=n)
    cj = torch.bincount(pj[:count].long(), minlength=n)
    row_off = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    inc_start = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    row_off[1:] = torch.cumsum(ci, 0)
    inc_start[1:] = torch.cumsum(cj, 0)
    inc_pair = torch.zeros(pi.shape[0], dtype=torch.int32, device=dev)
    inc_pair[:count] = torch.sort(pj[:count].long(), stable=True).indices.to(torch.int32)
    return row_off.to(torch.int32), inc_start.to(torch.int32), inc_pair


def member(obj, b: int):
    """Member ``b``'s view of a batched value: a tensor's ``[b]``, a tuple or
    list element by element, a dataclass (a state, a cache, a collision set,
    an incidence) field by field; ``None`` and scalars as they are.  Only
    batched values are passed here: a topology's tensors have no member
    axis."""
    if isinstance(obj, torch.Tensor):
        return obj[b]
    if isinstance(obj, (tuple, list)):
        return type(obj)(member(o, b) for o in obj)
    if is_dataclass(obj) and not isinstance(obj, type):
        return replace(obj, **{f.name: member(getattr(obj, f.name), b) for f in fields(obj)})
    return obj


def stack_members(items: list):
    """The batched value of the members' values ``items`` (the inverse of
    :func:`member`): tensors stacked on a new leading axis, tuples, lists
    and dataclasses field by field; scalars, which the members share, taken
    from the first."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, (tuple, list)):
        return type(first)(stack_members(list(z)) for z in zip(*items))
    if is_dataclass(first) and not isinstance(first, type):
        return replace(first, **{f.name: stack_members([getattr(i, f.name) for i in items])
                                 for f in fields(first)})
    return first


def each_member(fn, n: int, *args):
    """The batched twin of a single-scene function: ``fn`` on member b's
    view of every argument, for b = 0 .. n-1 in order, the results stacked.
    In-place updates of the views land in the batched arguments."""
    return stack_members([fn(*(member(a, b) for a in args)) for b in range(n)])


def members_of(positions: torch.Tensor) -> int:
    """The member count of a batched f32[B, N, 3] node tensor, 0 for a
    single scene's f32[N, 3]."""
    return positions.shape[0] if positions.dim() == 3 else 0


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
    nn: NodePairCache | None = None

    @property
    def capacity(self) -> int:
        return self.positions.shape[-2]

    @property
    def members(self) -> int:
        """The ensemble's member count, 0 for a single scene."""
        return members_of(self.positions)

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def failed(self) -> bool:
        """Host read of the latch (waits for the device)."""
        return bool(self.sim_failed.any().item())


def clone_state(obj):
    """A deep copy of a state (or of any of its caches): every tensor
    cloned, dataclasses field by field."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if is_dataclass(obj):
        return replace(obj, **{f.name: clone_state(getattr(obj, f.name)) for f in fields(obj)})
    return obj


def stack_ensemble(state: SolverState, n: int) -> SolverState:
    """An ``n``-member ensemble of copies of the single scene ``state``
    (``pies_tpu/parallel/ensemble.py:34``): every leaf gets a leading
    member axis, as a contiguous copy (the tick writes it in place, so the
    members must not share memory as a broadcast view would)."""
    if state.members:
        raise ValueError("stack_ensemble takes a single scene's state")
    return stack_members([clone_state(state) for _ in range(n)])


def unstack(states: SolverState, b: int) -> SolverState:
    """Member ``b`` of an ensemble as an ordinary state (a copy)."""
    return clone_state(member(states, b))


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

    # (a copy each: positions and prev_positions must not share memory)
    dev = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
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


def _leaves(state: SolverState) -> list[np.ndarray]:
    """The state's leaves as the JAX package's pytree flattens its state:
    the field order of ``pies_tpu/state.py:95-113``, a bool scalar latch,
    bool masks and flags, scalar counts."""
    f32 = lambda t: t.detach().cpu().numpy()
    out = [f32(getattr(state, k)) for k in ("positions", "prev_positions", "velocities",
                                            "forces", "inv_mass", "mass", "radius",
                                            "node_mask", "shape_quats")]
    out.append(np.asarray(bool(state.sim_failed.any())))
    if state.bp is not None:
        bp = state.bp
        out += [f32(bp.pairs), f32(bp.valid).astype(bool), f32(bp.ref),
                np.asarray(bool(bp.fresh[0]))]
    if state.nn is not None:
        nn = state.nn
        out += [f32(nn.pi), f32(nn.pj), np.asarray(int(nn.count[0]), np.int32), f32(nn.ref),
                np.asarray(bool(nn.fresh[0]))]
    return out


def save_state(path: str, state: SolverState) -> None:
    """Checkpoint (``pies_tpu/state.py:216-223``): the leaves as an npz,
    ``leaf_0`` .. ``leaf_k`` in the JAX package's order."""
    np.savez(path, **{f"leaf_{i}": leaf for i, leaf in enumerate(_leaves(state))})


def load_state(path: str, like: SolverState) -> SolverState:
    """Restore a checkpoint of :func:`save_state` or of the JAX package's
    ``save_state`` into a state shaped like ``like`` (the caches it has are
    read; the node-pair incidence is rebuilt from the pair prefix)."""
    data = np.load(path)
    leaf = iter(data[f"leaf_{i}"] for i in range(len(data.files)))
    dev = like.device
    t = lambda a, dtype=torch.float32: torch.from_numpy(np.array(a)).to(dev, dtype)
    i32 = torch.int32
    out = SolverState(**{k: t(next(leaf)) for k in (
        "positions", "prev_positions", "velocities", "forces", "inv_mass", "mass", "radius",
        "node_mask")}, sim_failed=torch.zeros(2, dtype=i32, device=dev))
    out.shape_quats = t(next(leaf))
    out.sim_failed[0] = int(bool(next(leaf)))
    if like.bp is not None:
        pairs, valid, ref, fresh = (next(leaf) for _ in range(4))
        valid = np.asarray(valid, bool)
        out.bp = BroadphaseCache(pairs=t(np.where(valid, pairs, 0), i32), valid=t(valid, i32),
                                 ref=t(ref), fresh=t(np.reshape(fresh, 1), i32),
                                 rebuilt=torch.zeros(1, dtype=i32, device=dev))
    if like.nn is not None:
        pi, pj, count, ref, fresh = (next(leaf) for _ in range(5))
        n, count = out.capacity, int(count)
        pi, pj = t(pi, i32), t(pj, i32)
        row_off, inc_start, inc_pair = pair_incidence(pi, pj, count, n)
        out.nn = NodePairCache(pi=pi, pj=pj, count=t(np.reshape(count, 1), i32), ref=t(ref),
                               fresh=t(np.reshape(fresh, 1), i32), row_off=row_off,
                               inc_start=inc_start, inc_pair=inc_pair,
                               rebuilt=torch.zeros(1, dtype=i32, device=dev))
    return out
