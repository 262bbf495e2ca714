"""Position-Based Dynamics substep (port of ``pies_tpu/solver/pbd.py``).

A substep advects, then runs ``iterations`` rounds of direct projection,
node-node response and floor clamp, then the damped velocity update with
floor friction (``Solver::tickPBD``, ``Solver.cpp:40-160``).  Each family of
constraints is projected from the same positions and applied count-averaged
per node (Jacobi within a family), families in the reference's order
(``_apply_jacobi``, ``pbd.py:32-53``); the distance constraints take one of
three forms (``pbd.py:91-160``): the exact chain walk of ropes, the colour
classes of other nets, or Jacobi.

On the card a substep is a fixed sequence of launches, each with a plain
twin (``*_plain``) for the CPU and as the oracle:

* T18 (``kernels/csrc/pbd_constraints.cu``): :func:`substep_head`, per
  family ``projections.jacobi_rows`` (stage 1) and :func:`apply_jacobi`
  (stage 2, the count-averaged per-node sum over the topology's
  incidence), :func:`floor_clamp` and :func:`substep_tail`;
* T19 (``kernels/csrc/pbd_distance_seq.cu``): :func:`chain_scan` and
  :func:`color_classes`;
* with collisions on, T20 and T21 (``collision/broadphase.py``
  ``node_pairs``, ``node_response``): the node-pair cache and the response.

The positions are updated in place on the state, the node-node response
writes new buffers (every node reads its neighbours' old state), and the
tail writes the state.  Every kernel returns at once when latch slot 0 is
set, so a failed tick changes nothing; the host never waits for the device
within a tick.

An ensemble state (``state.py``: every leaf with a leading member axis B,
the node-pair cache's too) runs with the same launches as one member
(ROADMAP item 10b-iv): T18, T19 and T21 take the member axis (the colour
classes stay one launch per class), T20 keeps each member's pair cache
across ticks and rebuilds it on that member's own drift, and each kernel
reads its member's latch, so a latched member is left bit for bit as it is
and counts nothing.  Each plain twin loops over the members
(``state.each_member``); the residual is 0 f32[B] and the counters are
per member.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..collision.batches import Incidence, csr_sum
from ..constraints import projections as proj
from ..ops.math3d import ieee_div as _div
from ..options import PhysicsParams, StepConfig
from ..state import SolverState, each_member, members_of
from ..topology import ChainBatch, DistanceBatch, Topology


def _keep(v) -> float:
    """``1 − v`` as the float32 the JAX package computes."""
    return float(np.float32(1.0) - np.float32(v))


def _fold_latch(failed: torch.Tensor) -> None:
    """First substep of a tick: slot 0 takes slot 1 (see state.py), in
    each member's row of an ensemble's i32[B, 2]."""
    failed[..., 0:1].bitwise_or_(failed[..., 1:2])


def _latched(failed) -> bool:
    """Host read of a single scene's latch slot 0 (False without a latch)."""
    return failed is not None and bool(failed[0])


# ---------------------------------------------------------------------------
# T18: the Jacobi application, head, floor clamp and tail


def apply_jacobi_plain(x: torch.Tensor, inc: Incidence, vals: torch.Tensor,
                       failed=None) -> None:
    """Plain twin of T18's stage 2, in place: ``x += acc / max(cnt, 1)``
    with ``(acc, cnt)`` the sums of the rows ``vals`` f32[E, 4] over each
    node's entries of ``inc``, from 0.0 in ascending entry order; nothing
    moves when latch slot 0 is set.  An ensemble (``x`` f32[B, N, 3], rows
    f32[B, E, 4], latch i32[B, 2]) runs member by member."""
    if members_of(x):
        each_member(lambda xb, vb, fb: apply_jacobi_plain(xb, inc, vb, fb), members_of(x), x,
                    vals, failed)
        return
    if _latched(failed):
        return
    acc = csr_sum(inc, vals)
    x.copy_(x + acc[:, :3] / torch.clamp_min(acc[:, 3:4], 1.0))


def apply_jacobi(x: torch.Tensor, inc: Incidence, vals: torch.Tensor, failed=None) -> None:
    """T18's stage 2 on a CUDA tensor (one launch for all members),
    :func:`apply_jacobi_plain` on a CPU tensor."""
    if kernels.on_cpu(x):
        return apply_jacobi_plain(x, inc, vals, failed)
    members = kernels.launch_members(x, failed, vals)
    kernels.require(x.device, x, inc.row_start, inc.entries, vals, failed)
    err = kernels.lib().pies_pbd_apply(x.data_ptr(), inc.row_start.data_ptr(),
                                       inc.entries.data_ptr(), vals.data_ptr(), x.shape[-2],
                                       vals.shape[-2], failed.data_ptr(), members,
                                       kernels.stream())
    kernels.check(err, "pbd_apply")
    apply_jacobi.launches += 1


apply_jacobi.launches = 0


def substep_head_plain(state: SolverState, params: PhysicsParams, fold: bool) -> None:
    """Plain twin of T18's head (``pbd.py:74-79``), in place: ``prev = x``,
    then ``x += (v·dt + g·dt·dt)·mask`` with ``g = (0, −gravity, 0)``.  The
    first substep of a tick folds latch slot 1 into slot 0; nothing moves
    when slot 0 is set.  An ensemble runs member by member."""
    if state.members:
        each_member(lambda s: substep_head_plain(s, params, fold), state.members, state)
        return
    if fold:
        _fold_latch(state.sim_failed)
    if _latched(state.sim_failed):
        return
    dt = params.dt
    grav = torch.zeros_like(state.positions)
    grav[:, 1] = -params.gravity
    state.prev_positions.copy_(state.positions)
    state.positions.copy_(state.positions + (state.velocities * dt + (grav * dt) * dt)
                          * state.node_mask[:, None])


def substep_head(state: SolverState, params: PhysicsParams, fold: bool) -> None:
    """T18's head on a CUDA state (one launch for all members, each
    folding its own latch), :func:`substep_head_plain` on a CPU state."""
    pos = state.positions
    if kernels.on_cpu(pos):
        return substep_head_plain(state, params, fold)
    kernels.require(pos.device, pos, state.prev_positions, state.velocities, state.node_mask,
                    state.sim_failed)
    err = kernels.lib().pies_pbd_head(
        pos.data_ptr(), state.prev_positions.data_ptr(), state.velocities.data_ptr(),
        state.node_mask.data_ptr(), state.capacity, params.dt, params.gravity,
        state.sim_failed.data_ptr(), int(fold), max(state.members, 1), kernels.stream())
    kernels.check(err, "pbd_head")
    substep_head.launches += 1


substep_head.launches = 0


def floor_clamp_plain(x: torch.Tensor, radius: torch.Tensor, node_mask: torch.Tensor,
                      floor_height: float, failed=None) -> None:
    """Plain twin of T18's floor clamp (``pbd.py:187-191``), in place:
    ``y += (floor + r) − y`` where that is positive, on live nodes; nothing
    moves when latch slot 0 is set.  An ensemble runs member by member."""
    if members_of(x):
        each_member(lambda xb, rb, mb, fb: floor_clamp_plain(xb, rb, mb, floor_height, fb),
                    members_of(x), x, radius, node_mask, failed)
        return
    if _latched(failed):
        return
    lift = (floor_height + radius) - x[:, 1]
    x[:, 1] = x[:, 1] + torch.where((lift > 0) & (node_mask > 0), lift, 0.0)


def floor_clamp(x: torch.Tensor, radius: torch.Tensor, node_mask: torch.Tensor,
                floor_height: float, failed=None) -> None:
    """T18's floor clamp on a CUDA tensor, its twin on a CPU tensor."""
    if kernels.on_cpu(x):
        return floor_clamp_plain(x, radius, node_mask, floor_height, failed)
    members = kernels.launch_members(x, failed, radius, node_mask)
    kernels.require(x.device, x, radius, node_mask, failed)
    err = kernels.lib().pies_pbd_floor(x.data_ptr(), radius.data_ptr(), node_mask.data_ptr(),
                                       x.shape[-2], floor_height, failed.data_ptr(), members,
                                       kernels.stream())
    kernels.check(err, "pbd_floor")
    floor_clamp.launches += 1


floor_clamp.launches = 0


def substep_tail_plain(state: SolverState, x: torch.Tensor, params: PhysicsParams) -> None:
    """Plain twin of T18's tail (``pbd.py:200-216``), in place on the
    state: ``vel = (1 − damping)·(x − prev)/dt·mask``; on the floor (``y −
    r ≤ floor``) the xz velocity stops below 5.0 and is scaled by ``1 −
    friction`` otherwise; ``positions = prev = x``; non-finite positions
    set latch slot 1.  ``x`` may be ``state.positions``.  Nothing changes
    when slot 0 is set; an ensemble runs member by member."""
    if state.members:
        each_member(lambda s, xb: substep_tail_plain(s, xb, params), state.members, state, x)
        return
    if _latched(state.sim_failed):
        return
    m = state.node_mask
    vel = _div(_keep(params.damping) * (x - state.prev_positions), params.dt) * m[:, None]
    on_floor = (x[:, 1] - state.radius <= params.floor_height) & (m > 0)
    xz = torch.sqrt(vel[:, 0] * vel[:, 0] + vel[:, 2] * vel[:, 2])
    scale = torch.where(on_floor & (xz < 5.0), 0.0,
                        torch.where(on_floor, _keep(params.friction), 1.0))
    vel[:, 0] = vel[:, 0] * scale
    vel[:, 2] = vel[:, 2] * scale
    bad = ~torch.isfinite(x).all()
    state.positions.copy_(x)
    state.prev_positions.copy_(x)
    state.velocities.copy_(vel)
    state.sim_failed[1:2].bitwise_or_(bad.to(torch.int32))


def substep_tail(state: SolverState, x: torch.Tensor, params: PhysicsParams) -> None:
    """T18's tail on a CUDA state (one launch for all members, each
    latching its own slot 1), :func:`substep_tail_plain` on a CPU state."""
    pos = state.positions
    if kernels.on_cpu(pos):
        return substep_tail_plain(state, x, params)
    kernels.require(pos.device, pos, state.prev_positions, state.velocities, x, state.radius,
                    state.node_mask, state.sim_failed)
    err = kernels.lib().pies_pbd_tail(
        pos.data_ptr(), state.prev_positions.data_ptr(), state.velocities.data_ptr(),
        x.data_ptr(), state.radius.data_ptr(), state.node_mask.data_ptr(), state.capacity,
        params.dt, _keep(params.damping), _keep(params.friction), params.floor_height,
        state.sim_failed.data_ptr(), max(state.members, 1), kernels.stream())
    kernels.check(err, "pbd_tail")
    substep_tail.launches += 1


substep_tail.launches = 0


# ---------------------------------------------------------------------------
# T19: the chain walk and the colour classes


def chain_scan_plain(x: torch.Tensor, ch: ChainBatch, failed=None) -> None:
    """Plain twin of T19's chain walk (``pbd.py:91-123``), in place: down
    each chain, ``delta = w·(−(rest − dist)·dir)`` toward the chase target
    (the just-moved node, the anchor first), every node read from the
    positions before the walk; all deltas are added after it, a padding
    link's zero to node 0, as the JAX package does.  Nothing moves when
    latch slot 0 is set; an ensemble runs member by member."""
    if members_of(x):
        each_member(lambda xb, fb: chain_scan_plain(xb, ch, fb), members_of(x), x, failed)
        return
    if _latched(failed):
        return
    tgt = x[ch.anchor.long()]
    deltas = []
    for k in range(ch.idx0.shape[1]):
        pa = x[ch.idx0[:, k].long()]
        dirs, dist = proj.pbd_direction(pa, tgt)
        disp = ch.rest[:, k] - dist
        delta = torch.stack([ch.w[:, k] * ((-disp) * dirs[d]) for d in range(3)], dim=1)
        tgt = pa + delta
        deltas.append(delta)
    if deltas:
        x.index_add_(0, ch.idx0.t().reshape(-1).long(), torch.cat(deltas))


def chain_scan(x: torch.Tensor, ch: ChainBatch, failed=None) -> None:
    """T19's chain walk on a CUDA tensor (one thread per chain; padding
    links write nothing; one launch for all members), :func:`chain_scan_plain`
    on a CPU tensor."""
    if kernels.on_cpu(x):
        return chain_scan_plain(x, ch, failed)
    c, l = ch.idx0.shape
    members = kernels.launch_members(x, failed)
    kernels.require(x.device, x, ch.idx0, ch.anchor, ch.rest, ch.w, failed)
    err = kernels.lib().pies_pbd_chains(x.data_ptr(), ch.idx0.data_ptr(), ch.anchor.data_ptr(),
                                        ch.rest.data_ptr(), ch.w.data_ptr(), c, l, x.shape[-2],
                                        failed.data_ptr(), members, kernels.stream())
    kernels.check(err, "pbd_chains")
    chain_scan.launches += 1


chain_scan.launches = 0


def color_classes_plain(x: torch.Tensor, d: DistanceBatch, ends: tuple, failed=None) -> None:
    """Plain twin of T19's colour classes (``pbd.py:124-152``), in place:
    class after class, each constraint's node 0 moves by ``w·(−(rest −
    dist)·dir)``; no node repeats within a class.  Nothing moves when latch
    slot 0 is set; an ensemble runs member by member."""
    if members_of(x):
        each_member(lambda xb, fb: color_classes_plain(xb, d, ends, fb), members_of(x), x,
                    failed)
        return
    if _latched(failed):
        return
    s0 = 0
    for e0 in ends:
        i0, i1 = d.idx[s0:e0, 0].long(), d.idx[s0:e0, 1].long()
        pa, pb = x[i0], x[i1]
        dirs, dist = proj.pbd_direction(pa, pb)
        disp = d.rest[s0:e0] - dist
        w = d.w[s0:e0]
        x[i0] = pa + torch.stack([w * ((-disp) * dirs[k]) for k in range(3)], dim=1)
        s0 = e0


def color_classes(x: torch.Tensor, d: DistanceBatch, ends: tuple, failed=None) -> None:
    """T19's colour classes on a CUDA tensor, one launch per class at any
    member count; :func:`color_classes_plain` on a CPU tensor."""
    if kernels.on_cpu(x):
        return color_classes_plain(x, d, ends, failed)
    members = kernels.launch_members(x, failed)
    kernels.require(x.device, x, d.idx, d.rest, d.w, failed)
    lib, st = kernels.lib(), kernels.stream()
    s0 = 0
    for e0 in ends:
        err = lib.pies_pbd_color_class(x.data_ptr(), d.idx.data_ptr(), d.rest.data_ptr(),
                                       d.w.data_ptr(), s0, e0, x.shape[-2], failed.data_ptr(),
                                       members, st)
        kernels.check(err, "pbd_color_class")
        color_classes.launches += 1
        s0 = e0


color_classes.launches = 0


# ---------------------------------------------------------------------------
# the substep

COUNTERS = ("floor_active", "pairs", "touching", "rebuilds")


def new_counters(device, members: int = 0) -> dict[str, torch.Tensor]:
    """Zeroed device counters for :func:`pbd_substep`, each summed over
    substeps: nodes on the floor after the substep, live cached pairs and
    touching pairs per iteration, pair-cache rebuilds; i64[members] for an
    ensemble."""
    shape = (members,) if members else ()
    return {name: torch.zeros(shape, dtype=torch.int64, device=device) for name in COUNTERS}


_KERNELS = dict(head=substep_head, rows=proj.jacobi_rows, apply=apply_jacobi,
                chains=chain_scan, colors=color_classes, floor=floor_clamp, tail=substep_tail)
_PLAIN = dict(head=substep_head_plain, rows=proj.jacobi_rows_plain, apply=apply_jacobi_plain,
              chains=chain_scan_plain, colors=color_classes_plain, floor=floor_clamp_plain,
              tail=substep_tail_plain)


def pbd_substep(state: SolverState, topo: Topology, params: PhysicsParams,
                config: StepConfig, detect_node_pairs, fold: bool, plain: bool = False,
                counters: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """One PBD substep in place on ``state`` (``pies_tpu/solver/pbd.py:56``);
    returns a zero residual, as the JAX package does (f32[B] for an
    ensemble).
    ``detect_node_pairs(state, x, vel, params, config, cache, plain)`` is the
    node-node response (``step.default_detect_node_pairs``), returning ``(x,
    vel, touching, rebuilt)`` (the last two None when it does nothing).
    ``plain=True`` runs the plain twins whatever the device; ``counters``
    (:func:`new_counters`) are summed on the device; a latched scene or
    member counts nothing."""
    k = _PLAIN if plain else _KERNELS
    failed = state.sim_failed
    zero = torch.zeros(state.positions.shape[:-2], dtype=state.positions.dtype,
                       device=state.device)
    k["head"](state, params, fold)
    if (plain or kernels.on_cpu(state.positions)) and bool(failed[..., 0].all()):
        return zero
    live = failed[..., 0] == 0  # (slot 0 holds for the rest of the substep)
    x, vel = state.positions, state.velocities
    inc, im = topo.jacobi, state.inv_mass

    def family(kind, batch, incidence, **kw):
        if batch.idx.shape[0]:
            k["apply"](x, incidence, k["rows"](kind, x, im, batch, failed=failed, **kw), failed)

    for _ in range(config.iterations):
        # Pins gated by releaseHinge (Solver.cpp:59-63), then the distance
        # form, strain and bend, each count-averaged (Solver.cpp:65-75).
        family("position", topo.position, inc.position,
               w_scale=_keep(params.release_hinge))
        if config.distance_chain and topo.chains is not None:
            k["chains"](x, topo.chains, failed)
        elif config.distance_colors:
            k["colors"](x, topo.distance, config.distance_colors, failed)
        else:
            family("distance", topo.distance, inc.distance)
        family("strain", topo.strain, inc.strain, recenter=not config.reference_quirks)
        family("bend", topo.bend, inc.bend)
        # Node-node response + friction impulses (Solver.cpp:81-130); the
        # velocity impulses persist across iterations.
        x, vel, touching, rebuilt = detect_node_pairs(state, x, vel, params, config, state.nn,
                                                      plain)
        if counters is not None and touching is not None:
            if state.nn is not None:  # without a cache the call's pairs are not kept
                counters["pairs"].add_(torch.where(live, state.nn.count[..., 0], 0))
            counters["touching"].add_(touching[..., 0])
            counters["rebuilds"].add_(rebuilt[..., 0])
        k["floor"](x, state.radius, state.node_mask, params.floor_height, failed)
    k["tail"](state, x, params)
    if counters is not None:
        on = ((state.positions[..., 1] - state.radius <= params.floor_height)
              & (state.node_mask > 0) & live[..., None])
        counters["floor_active"].add_(on.sum(-1))
    return zero
