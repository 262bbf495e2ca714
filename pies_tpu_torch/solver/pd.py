"""Projective Dynamics substep (port of ``pies_tpu/solver/pd.py``).

A substep is a fixed sequence of launches on the card, each with a plain
PyTorch twin.  On the tet-column path (disjoint tet soups):

* T3 :func:`substep_head` — inertia estimate, floor detection on the
  predicted positions, the system diagonal and the floor weight;
* with self-contact on: the point-triangle detection
  (``collision/broadphase.py``: T5 and T6 on packed bodies, else T16 and
  T17), and T7's setup (``tetcols.pt_coupling_setup``),
  the node incidence and the contacts' diagonal;
* T2 ``tetcols.substep_cols`` — the PD iterations with the direct 4x4 block
  solve, the stale static projection and the residual, the first
  iteration's tet force (T1's function, ``tet_force12``) computed in its
  registers from the predicted positions; with self-contact on
  ``tetcols.contact_substep``: one cooperative launch, the tets with
  contact entries iteration by iteration and the others in registers,
  computing T7's contact force (``tetcols.pt_force``'s) at each
  iteration's iterate;
* with self-contact on: T8 :func:`pt_tail` — the stabilization passes with
  the floor snap between them and the contact friction;
* T4 :func:`substep_tail` — floor snap, velocity, floor friction, the state
  update and the failure latch, in place on the state.

On the generic path (every other scene: wherever ``tetcols.applies``
fails, as in the JAX package): T3, and on the entry-list floor
(``dense_floor=False``) T24 :func:`floor_entries`; with self-contact on
the detection (T5 and T6 on packed bodies, T14 and T15 on the super-body
layout, T16 and T17 on the per-triangle branches) and T7's setup; where the
disjoint-tet block layout covers the capacity, T22's block factor; then
per PD iteration the local step (``assembly.local_step``: T12 for distance
and bend constraints, T13 for shape and goal groups, T9's stage 1 for
tets, each filling its part of one force-row buffer), T9's stage 2
(``assembly.assemble_force``: the per-node sum and the right-hand side)
and a PCG solve (``assembly.pcg_solve``: T10 operator applies and T11
vector stages, Jacobi or T22's block solve).  Contacts enter by
``contact_coupling``: recentered or diagonal, T7's force before T9's stage
2, which adds it with the lag term; full, T23's terms inside T9's stage 2
(the stacked force) and T10 (the contacts' blocks).  Edge-edge contacts
(T16 and T25's detection, T26's setup) add their terms to T9's stage 2,
under full coupling their blocks to T10, and their stabilization pass to
T8; node-node contacts (T20's fresh pair prefix, T27's setup) add their
projection to T9's stage 2 and their friction (T27) before T8's.  Then T8
with contacts, and T4.  The shape groups'
rotations (``state.shape_quats``) are carried from iteration to iteration
and tick to tick, in place.

The JAX package's ``lax.cond``s and ``while_loop``s on runtime data (any
contact, any live pair, any crossing, the CG's early exit) become device
counts and flags that the kernels read and exit on: the host never waits
for the device within a tick.

An ensemble state (``state.py``: every leaf with a leading member axis)
runs with the same launches as one member: on the tet-column path T1-T8
take the member axis (ROADMAP item 10a), on the generic path T3, T9-T13,
T22 and T4 (item 10b-i), each CG with its own exit per member, and its
point-triangle contacts in every detection branch and coupling and the
entry-list floor: T14-T17, T7, T8, T23 and T24 (item 10b-ii), and its
edge-edge and node-node contacts: T16 and T25, T26's setup and terms, T8's
edge pass, T20's pair prefix and T27 (item 10b-iii).  A tet-column
ensemble takes any detection branch too (item 10c): T14-T17 feed T2, T7
and T8 each member's contact list.  So the launch count
of a substep does not depend on the member count, and each plain twin
loops over the members (``state.each_member``).  Its residual and its
counters are per member.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..collision import broadphase
from ..collision.batches import (
    CollisionSet,
    Incidence,
    column_order,
    count_average,
    csr_sum,
    detect_floor_active,
    detect_floor_contacts,
    entry_values,
    floor_plane,
    floor_threshold,
    incidence_plain,
    incident,
    node_friction_pairs,
    node_pairs_of,
    stabilize_contacts,
    stabilize_edges,
    _dot3,
    _unit_normal_div,
)
from ..ops.math3d import ieee_div as _div
from ..options import PhysicsParams, StepConfig
from ..state import SolverState, each_member, members_of
from ..topology import Topology
from . import assembly, tetcols


def _h_h2(params: PhysicsParams) -> tuple[float, float]:
    """``h`` and ``h·h`` as the float32 values the JAX package computes."""
    h = np.float32(params.dt)
    return float(h), float(h * h)


def _fold_latch(failed: torch.Tensor) -> None:
    """First substep of a tick: slot 0 takes slot 1 (see state.py)."""
    failed[0:1].bitwise_or_(failed[1:2])


def self_contact(config: StepConfig, topo: Topology) -> bool:
    return config.enable_collisions and topo.triangles.shape[0] > 0


def edge_contact(config: StepConfig, topo: Topology) -> bool:
    """Edge-edge detection runs (``step.py:75``): the flag, and triangles."""
    return config.enable_edge_collisions and topo.triangles.shape[0] > 0


def check_detection(config: StepConfig) -> None:
    """Raise for a detection the port does not run: an unknown broadphase
    mode."""
    if config.enable_collisions:
        broadphase.check_detection(config)


def default_detect_collisions(x: torch.Tensor, topo: Topology,
                              params: PhysicsParams, config: StepConfig) -> CollisionSet:
    """The floor part of the PD collision detection for one substep
    (``pies_tpu/solver/step.py:26-44``): the dense floor, or the entry list
    with its per-node snap flags and counts through the corner incidence;
    the point-triangle part is :func:`detect_point_tri`."""
    check_detection(config)
    thr = floor_threshold(params)
    if config.dense_floor:
        return CollisionSet(floor_active=detect_floor_active(x, topo.floor_count, thr))
    static_idx, static_mask = detect_floor_contacts(x, topo.triangles, topo.tri_mask, thr)
    counts = csr_sum(topo.corner_inc, static_mask[:, None])[:, 0]
    return CollisionSet(floor_active=(counts > 0).to(x.dtype), static_idx=static_idx,
                        static_mask=static_mask, floor_counts=counts)


def detect_point_tri(state: SolverState, x: torch.Tensor, topo: Topology,
                     params: PhysicsParams, config: StepConfig, active: torch.Tensor,
                     plain: bool = False) -> CollisionSet:
    """The point-triangle branch of ``step.default_detect_collisions``
    (``pies_tpu/solver/step.py:55-74``): kernels T5 and T6 (packed bodies)
    or T14 and T15 (the super-body layout) against the state's cache, which
    is updated in place, or T16 and T17 (the per-triangle branches)."""
    pt_idx, pt_mask, pt_count, overflow, rebuilt = broadphase.detect_point_tri_collisions(
        x, state.prev_positions, topo.tri_mask, params, config, cache=state.bp,
        failed=state.sim_failed, plain=plain, corners=topo.super_corners,
        adj=topo.super_adj, triangles=topo.triangles)
    return CollisionSet(floor_active=active, pt_idx=pt_idx, pt_mask=pt_mask,
                        pt_count=pt_count, overflow=overflow, rebuilt=rebuilt)


def substep_head_plain(state: SolverState, topo: Topology, params: PhysicsParams,
                       config: StepConfig, fold: bool):
    """Plain twin of kernel T3.  Returns ``(x, msn_h2, diag, wf, active)``:
    the predicted positions and ``M·x/h²`` f32[N, 3], the system diagonal, the
    floor weight ``W_STATIC·count·active`` and the floor activity f32[N]
    (each with a leading member axis for an ensemble)."""
    if state.members:
        return each_member(lambda s: substep_head_plain(s, topo, params, config, fold),
                           state.members, state)
    if fold:
        _fold_latch(state.sim_failed)
    h, h2 = _h_h2(params)
    mask = state.node_mask[:, None]
    # Inertia estimate sₙ = q + h·v and Msₙ/h² (Solver.cpp:229-238).
    x = state.positions + h * state.velocities * mask
    mass_over_h2 = _div(state.mass, h2)
    msn_h2 = x * mass_over_h2[:, None]
    if config.dense_floor:
        colls = default_detect_collisions(x, topo, params, config)
    else:  # the entry-list floor comes after the head (floor_entries)
        check_detection(config)
        colls = CollisionSet(floor_active=torch.zeros_like(state.mass))
    diag = assembly.system_diag(mass_over_h2, topo, colls)
    wf = assembly.static_collision_diag(colls, topo.floor_count)
    return x, msn_h2, diag, wf, colls.floor_active


def substep_head(state: SolverState, topo: Topology, params: PhysicsParams,
                 config: StepConfig, fold: bool):
    """Kernel T3 on a CUDA state, :func:`substep_head_plain` on a CPU state.
    ``fold`` marks the first substep of a tick (the latch fold).  On the
    entry-list floor the kernel's dense floor test is off (its threshold
    −inf: no node is active, the floor weight is 0)."""
    pos = state.positions
    if kernels.on_cpu(pos):
        return substep_head_plain(state, topo, params, config, fold)
    check_detection(config)  # the kernel fuses the dense-floor detection
    n = state.capacity
    kernels.require(pos.device, pos, state.velocities, state.mass, state.node_mask,
                    topo.floor_count, topo.stiffness_diag, state.sim_failed)
    x = torch.empty_like(pos)
    msn = torch.empty_like(pos)
    diag, wf, active = (torch.empty(pos.shape[:-1], dtype=torch.float32, device=pos.device)
                        for _ in range(3))
    h, h2 = _h_h2(params)
    err = kernels.lib().pies_substep_head(
        pos.data_ptr(), state.velocities.data_ptr(), state.mass.data_ptr(),
        state.node_mask.data_ptr(), topo.floor_count.data_ptr(),
        topo.stiffness_diag.data_ptr(), x.data_ptr(), msn.data_ptr(),
        diag.data_ptr(), wf.data_ptr(), active.data_ptr(), n, h, h2,
        floor_threshold(params) if config.dense_floor else -float("inf"),
        state.sim_failed.data_ptr(), int(fold), max(state.members, 1),
        kernels.stream(),
    )
    kernels.check(err, "substep_head")
    substep_head.launches += 1
    return x, msn, diag, wf, active


substep_head.launches = 0


def floor_entries_plain(x: torch.Tensor, topo: Topology, params: PhysicsParams,
                        config: StepConfig, diag: torch.Tensor, failed=None):
    """Plain twin of kernel T24, the entry-list floor after the head: the
    corner entries (``batches.py:104-124``), per node through the corner
    incidence the floor weight ``wf = Σ w·mask`` (``assembly.py:338-353``),
    added to ``diag`` in place, the count of live entries and the snap flag.
    Returns ``(wf f32[N], CollisionSet)`` with ``floor_active`` the snap
    flags.  ``failed`` is accepted for signature parity.  An ensemble (``x``
    f32[B, N, 3], ``diag`` f32[B, N]) runs member by member."""
    if members_of(x):
        return each_member(lambda xb, db: floor_entries_plain(xb, topo, params, config, db),
                           members_of(x), x, diag)
    colls = default_detect_collisions(x, topo, params, config)
    wf = assembly.static_collision_diag(colls, topo.floor_count, topo.corner_inc)
    diag.copy_(diag + wf)
    return wf, colls


def floor_entries(x: torch.Tensor, topo: Topology, params: PhysicsParams,
                  config: StepConfig, diag: torch.Tensor, failed=None):
    """Kernel T24 on CUDA tensors, :func:`floor_entries_plain` on CPU
    tensors.  On the card ``failed`` is required: nothing is written when
    its slot 0 is set (a member's slot, in an ensemble, whose entry list
    ``static_idx`` is the corner list copied per member, as the twin's)."""
    if kernels.on_cpu(x):
        return floor_entries_plain(x, topo, params, config, diag, failed)
    if failed is None:
        raise ValueError("the floor entry kernel needs the failure latch")
    n = x.shape[-2]
    lead = x.shape[:-2]
    inc = topo.corner_inc
    members = kernels.launch_members(x, failed)
    if tuple(diag.shape) != lead + (n,):
        raise ValueError("the diagonal needs the positions' member axis")
    kernels.require(x.device, x, inc.row_start, inc.entries, topo.tri_mask, diag, failed)
    f32 = dict(dtype=torch.float32, device=x.device)
    static_mask = torch.empty(lead + (inc.cap,), **f32)
    wf, active, counts = (torch.empty(lead + (n,), **f32) for _ in range(3))
    err = kernels.lib().pies_floor_entries(
        x.data_ptr(), inc.row_start.data_ptr(), inc.entries.data_ptr(),
        topo.tri_mask.data_ptr(), floor_threshold(params), static_mask.data_ptr(),
        diag.data_ptr(), wf.data_ptr(), active.data_ptr(), counts.data_ptr(), n, inc.cap,
        failed.data_ptr(), members, kernels.stream())
    kernels.check(err, "floor_entries")
    floor_entries.launches += 1
    static_idx = topo.triangles.reshape(-1).expand(lead + (inc.cap,)).contiguous()
    return wf, CollisionSet(floor_active=active, static_idx=static_idx,
                            static_mask=static_mask, floor_counts=counts)


floor_entries.launches = 0


def _static_floor_friction(vel: torch.Tensor, colls: CollisionSet,
                           params: PhysicsParams, floor_count: torch.Tensor) -> torch.Tensor:
    """Floor friction (``Solver.cpp:473-484``, ``pd.py:589-617``): a node hit
    by k floor entries decays its xz velocity by ``(1−f)^k``, the static
    threshold evaluated at the velocity before the pass (FIDELITY.md); k is
    ``floor_count·active`` on the dense floor, the entry list's count
    otherwise."""
    counts = (floor_count * colls.floor_active if colls.floor_counts is None
              else colls.floor_counts)
    norm = torch.sqrt(vel[:, 0] * vel[:, 0] + vel[:, 2] * vel[:, 2])
    static = norm < params.static_friction_threshold
    keep = float(np.float32(1.0) - np.float32(params.friction))
    factor = torch.where(static, 0.0, torch.pow(keep, counts))
    factor = torch.where(counts > 0, factor, 1.0)
    out = vel.clone()
    out[:, 0] = vel[:, 0] * factor
    out[:, 2] = vel[:, 2] * factor
    return out


def base_velocity(x: torch.Tensor, prev: torch.Tensor, state: SolverState,
                  params: PhysicsParams) -> torch.Tensor:
    """``((1−damping)·(x − prev)/h + h·f·m⁻¹)·mask`` with the gravity force
    ``f = (0, −g·m·mask, 0)`` of ``step.tick`` (``Solver.cpp:224-226,394-397``)."""
    h, _ = _h_h2(params)
    forces = torch.zeros_like(x)
    forces[:, 1] = (-params.gravity * state.mass) * state.node_mask
    keep = float(np.float32(1.0) - np.float32(params.damping))
    return (_div(keep * (x - prev), h) + h * forces * state.inv_mass[:, None]) \
        * state.node_mask[:, None]


def friction_contacts(x, vel, inv_mass, pt_idx, pt_mask, params: PhysicsParams):
    """Per-contact friction and restitution impulses (``Solver.cpp:431-471``):
    returns f32[cap, 7] = (point share, triangle-corner share, mask)."""
    pa, pb, pc, pd_ = (x[pt_idx[:, j].long()] for j in range(4))
    va, vb, vc, vd = (vel[pt_idx[:, j].long()] for j in range(4))
    im = inv_mass[pt_idx.long()]
    avg = _div(vb + vc + vd, 3.0)
    n = _unit_normal_div(pb, pc, pd_)
    rel = va - avg
    v_dot_n = _dot3(rel, n)
    perp = rel - v_dot_n[:, None] * n
    perp_norm = torch.sqrt(perp[:, 0] * perp[:, 0] + perp[:, 1] * perp[:, 1]
                           + perp[:, 2] * perp[:, 2])
    friction = torch.where(perp_norm < params.static_friction_threshold, 1.0,
                           params.friction)
    tri_w = im[:, 1] + im[:, 2] + im[:, 3]
    w_sum = torch.clamp_min(im[:, 0] + tri_w, 1e-20)
    restitution = float(np.float32(1.1)) * torch.clamp_max(v_dot_n, 0.0)
    dv = ((-friction)[:, None] * perp - restitution[:, None] * n) * pt_mask[:, None]
    share = -dv * (tri_w / w_sum)[:, None]
    point = dv * (im[:, 0] / w_sum)[:, None]
    return torch.cat([point, share, pt_mask[:, None]], dim=1)


def point_tri_friction_acc(x, vel, inv_mass, pt_idx, pt_mask,
                           params: PhysicsParams) -> torch.Tensor:
    """The contact friction pass's ``[N, 4]`` accumulator (impulse sums and
    contact counts) over every entry of the buffer, before count-averaging
    (``pd.py:526-586``)."""
    count = torch.full((1,), pt_idx.shape[0], dtype=torch.int32, device=pt_idx.device)
    inc = incidence_plain(pt_idx, count, x.shape[0])
    vals = friction_contacts(x, vel, inv_mass, pt_idx, pt_mask, params)
    return csr_sum(inc, entry_values(vals))


STABILIZE, FRICTION = 1, 2  # T8's stages


def snap_target(config: StepConfig, x: torch.Tensor, static_proj: torch.Tensor) -> torch.Tensor:
    """T4's floor-snap target: the static projection, or ``x`` itself (no
    snap) without stabilization passes, since the reference snaps only
    inside them (``pd.py:353-355``)."""
    return static_proj if config.collision_stabilization_iterations > 0 else x


def pt_tail_plain(state: SolverState, params: PhysicsParams, config: StepConfig,
                  colls: CollisionSet, inc: Incidence | None, x: torch.Tensor,
                  static_proj: torch.Tensor, edges=None, nn_imp: torch.Tensor | None = None,
                  stages: int = STABILIZE | FRICTION, acc: bool = False) -> torch.Tensor:
    """Plain twin of kernel T8, the contact part of ``pd._finish_substep``
    (``pd.py:330-436``), in place on ``x`` and ``state.prev_positions`` at
    the nodes with contact entries.  Stage ``STABILIZE``:
    ``collision_stabilization_iterations`` passes, each the count-averaged
    point-triangle push-out (``colls.pt_idx``; None without self-contact),
    then with ``edges`` (T26's ``EdgeTerms``) the count-averaged edge-edge
    push-out from the positions it left (``batches.py:422-476``, in the
    ``idx.T`` order), then the floor snap at the nodes with entries.  Stage
    ``FRICTION``: the point-triangle friction and restitution at the
    velocity the tail computes plus ``nn_imp`` (the node-node friction's
    impulse, ``pd.py:398-402``).  Returns the count-averaged friction
    impulse f32[N, 3] that T4 adds (zero at nodes without point-triangle
    entries).  Does nothing without live contacts, or when latch slot 0 is
    set.  An ensemble runs member by member.

    ``acc`` (accumulate-only, :func:`pt_tail_acc_plain`): one stage's sums
    instead, nothing applied."""
    if acc:
        return pt_tail_acc_plain(state, params, colls, inc, x, edges, nn_imp, stages)
    if state.members:
        return each_member(lambda s, c, i, xx, sp, e, nb: pt_tail_plain(
            s, params, config, c, i, xx, sp, e, nb, stages),
            state.members, state, colls, inc, x, static_proj, edges, nn_imp)
    fric = torch.zeros_like(x)
    pt_live = colls.pt_idx is not None and int(colls.pt_count[0]) > 0
    e_live = edges is not None and int(edges.count[0]) > 0
    if bool(state.sim_failed[0]) or not (pt_live or e_live):
        return fric
    none = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    on_pt = (incident(inc) if pt_live else none)[:, None]
    on_e = (incident(edges.inc) if e_live else none)[:, None]
    prev = state.prev_positions
    thickness = params.collision_thickness
    if stages & STABILIZE:
        snap = (on_pt | on_e) & (colls.floor_active[:, None] > 0)
        e_inc = column_order(edges.inc, 4) if e_live else None
        for _ in range(config.collision_stabilization_iterations):
            if pt_live:
                vals = stabilize_contacts(x, state.inv_mass, colls.pt_idx, colls.pt_mask,
                                          thickness)
                delta = count_average(csr_sum(inc, entry_values(vals)))
                prev.copy_(torch.where(on_pt, prev + delta, prev))
                x.copy_(torch.where(on_pt, x + delta, x))
            if e_live:
                vals = stabilize_edges(x, state.inv_mass, edges.edge_idx, edges.edge_mask,
                                       thickness, edges.quirks)
                delta = count_average(csr_sum(e_inc, vals))
                prev.copy_(torch.where(on_e, prev + delta, prev))
                x.copy_(torch.where(on_e, x + delta, x))
            x.copy_(torch.where(snap, static_proj, x))
    if not (stages & FRICTION and pt_live):
        return fric
    vel = base_velocity(x, prev, state, params)
    if nn_imp is not None:
        vel = vel + nn_imp
    vals = friction_contacts(x, vel, state.inv_mass, colls.pt_idx, colls.pt_mask, params)
    return torch.where(on_pt, count_average(csr_sum(inc, entry_values(vals))), fric)


def pt_tail_acc_plain(state: SolverState, params: PhysicsParams, colls: CollisionSet,
                      inc: Incidence | None, x: torch.Tensor, edges=None,
                      nn_imp: torch.Tensor | None = None,
                      stages: int = STABILIZE) -> torch.Tensor:
    """Plain twin of T8's accumulate-only mode: the ``[N, 4]`` sums of one
    stage's per-entry records and their count, per node in the JAX
    scatter's order, nothing averaged or applied: under ``STABILIZE`` one
    pass of the point-triangle push-out (``colls.pt_idx``,
    ``batches.py:478-549`` ``stabilize_point_tri_acc``) or, without it, of
    the edge-edge push-out (``edges``, ``stabilize_edge_edge_acc``); under
    ``FRICTION`` the point-triangle friction at the tail's velocity plus
    ``nn_imp`` (``pd.py:526-586`` ``point_tri_friction_acc``).  Zero
    without live contacts or with latch slot 0 set.  The domain
    decomposition sums these over the slabs before it averages
    (``pies_tpu/parallel/domain.py:878-953``)."""
    if state.members:
        return each_member(lambda s, c, i, xx, e, nb: pt_tail_acc_plain(
            s, params, c, i, xx, e, nb, stages),
            state.members, state, colls, inc, x, edges, nn_imp)
    out = torch.zeros(x.shape[:-1] + (4,), dtype=x.dtype, device=x.device)
    pt_live = colls.pt_idx is not None and int(colls.pt_count[0]) > 0
    if bool(state.sim_failed[0]):
        return out
    thickness = params.collision_thickness
    if stages & STABILIZE:
        if colls.pt_idx is not None:
            if not pt_live:
                return out
            vals = stabilize_contacts(x, state.inv_mass, colls.pt_idx, colls.pt_mask, thickness)
            return csr_sum(inc, entry_values(vals))
        if edges is None or int(edges.count[0]) == 0:
            return out
        vals = stabilize_edges(x, state.inv_mass, edges.edge_idx, edges.edge_mask, thickness,
                               edges.quirks)
        return csr_sum(column_order(edges.inc, 4), vals)
    if not pt_live:
        return out
    vel = base_velocity(x, state.prev_positions, state, params)
    if nn_imp is not None:
        vel = vel + nn_imp
    vals = friction_contacts(x, vel, state.inv_mass, colls.pt_idx, colls.pt_mask, params)
    return csr_sum(inc, entry_values(vals))


def pt_tail(state: SolverState, params: PhysicsParams, config: StepConfig,
            colls: CollisionSet, inc: Incidence | None, x: torch.Tensor,
            static_proj: torch.Tensor, edges=None, nn_imp: torch.Tensor | None = None,
            stages: int = STABILIZE | FRICTION, acc: bool = False) -> torch.Tensor:
    """Kernel T8 on a CUDA state, :func:`pt_tail_plain` on a CPU state.  On
    the card the friction impulse is written only at nodes with
    point-triangle entries, which are the only ones T4 reads.  ``acc``
    (accumulate-only, one stage, the point-triangle contacts or else the
    edges): returns the stage's ``[N, 4]`` sums, as
    :func:`pt_tail_acc_plain`, and leaves ``x`` and the state as they are."""
    pos = state.positions
    if kernels.on_cpu(pos):
        return pt_tail_plain(state, params, config, colls, inc, x, static_proj, edges, nn_imp,
                             stages, acc)
    if acc and stages not in (STABILIZE, FRICTION):
        raise ValueError("the accumulate-only mode runs one stage")
    if acc and colls.pt_idx is not None:
        edges = None  # (one kind a launch: the point-triangle contacts first)
    pt = colls.pt_idx is not None
    if pt and (inc.node_list is None or inc.node_count is None):
        raise ValueError("the tail kernel needs the incidence's node list from"
                         " pt_coupling_setup")
    pt_t = ((colls.pt_idx, colls.pt_mask, colls.pt_count, inc.row_start, inc.entries,
             inc.node_list, inc.node_count) if pt else (None,) * 7)
    e_on = edges is not None and bool(stages & STABILIZE)
    e_t = ((edges.edge_idx, edges.edge_mask, edges.count, edges.inc.row_start,
            edges.inc.entries) if e_on else (None,) * 5)
    kernels.require(pos.device, x, state.prev_positions, static_proj, colls.floor_active,
                    *pt_t, *e_t, nn_imp, state.inv_mass, state.mass, state.node_mask,
                    state.sim_failed)
    lead = pos.shape[:-2]  # (B,) for an ensemble
    kernels.launch_members(x, state.sim_failed, *pt_t, *e_t, nn_imp)
    cap = colls.pt_idx.shape[-2] if pt else 0
    ecap = edges.edge_idx.shape[-2] if e_on else 0
    per_contact = torch.empty(lead + (cap, 8), dtype=torch.float32, device=pos.device)
    per_entry = torch.empty(lead + (4 * ecap, 4), dtype=torch.float32, device=pos.device)
    fric = torch.empty_like(x)
    sums = torch.zeros(x.shape[:-1] + (4,), dtype=torch.float32, device=pos.device) if acc \
        else None
    h, _ = _h_h2(params)
    err = kernels.lib().pies_pt_tail(
        x.data_ptr(), state.prev_positions.data_ptr(), static_proj.data_ptr(),
        colls.floor_active.data_ptr(), *(kernels.ptr(t) for t in pt_t),
        *(kernels.ptr(t) for t in e_t), kernels.ptr(nn_imp), state.inv_mass.data_ptr(),
        state.mass.data_ptr(), state.node_mask.data_ptr(), per_contact.data_ptr(),
        per_entry.data_ptr(), fric.data_ptr(), kernels.ptr(sums), state.sim_failed.data_ptr(),
        state.capacity, cap, ecap, 1 if acc else config.collision_stabilization_iterations,
        int(stages),
        int(e_on and edges.quirks), params.collision_thickness, h, params.damping,
        params.gravity, params.friction, params.static_friction_threshold,
        max(state.members, 1), kernels.stream(),
    )
    kernels.check(err, "pt_tail")
    pt_tail.launches += 1
    if e_on:
        assembly.edge_terms.launches += 1
    return sums if acc else fric


pt_tail.launches = 0


def node_friction_plain(x: torch.Tensor, state: SolverState, params: PhysicsParams,
                        nodes, failed=None, acc: bool = False):
    """Plain twin of T27's friction stage (``pd.py:438-508``): per live
    pair the impulses at the velocity the tail computes, summed per node in
    the JAX package's ``idx.T`` order and count-averaged.  Returns ``(imp
    f32[N, 3], touching i32[1])``: the impulse (zero at nodes without a
    touching pair) and the touching pairs.  An ensemble (``x`` f32[B, N, 3],
    ``state``, ``nodes`` and ``failed`` per member) runs member by member."""
    if members_of(x):
        return each_member(lambda xb, sb, nb, fb: node_friction_plain(xb, sb, params, nb, fb),
                           members_of(x), x, state, nodes, failed)
    touching = torch.zeros(1, dtype=torch.int32, device=x.device)
    imp = torch.zeros_like(x)
    if failed is not None and bool(failed[0]):
        return imp, touching
    idx, mask = node_pairs_of(nodes.nn, nodes.cap)
    vel = base_velocity(x, state.prev_positions, state, params)
    vals = node_friction_pairs(x, vel, state.inv_mass, state.radius, idx, mask,
                               params.friction, params.static_friction_threshold)
    inc = column_order(incidence_plain(idx, nodes.lim, x.shape[0], row_major=True), 2)
    rows = torch.stack([torch.cat([vals[:, 0:3], vals[:, 6:7]], dim=1),
                        torch.cat([vals[:, 3:6], vals[:, 6:7]], dim=1)], dim=1).reshape(-1, 4)
    touching[0] = int(vals[:, 6].sum())
    sums = csr_sum(inc, rows)
    return (sums if acc else count_average(sums)), touching


def node_friction(x: torch.Tensor, state: SolverState, params: PhysicsParams, nodes,
                  failed=None, acc: bool = False):
    """T27's friction stage on a CUDA state, :func:`node_friction_plain` on
    a CPU state (the count stays on the device; an ensemble is one launch
    for all members)."""
    if kernels.on_cpu(x):
        return node_friction_plain(x, state, params, nodes, failed, acc)
    if failed is None:
        raise ValueError("the node contact kernel needs the failure latch")
    nn = nodes.nn
    members = kernels.launch_members(x, failed, state.prev_positions, state.inv_mass,
                                     state.mass, state.node_mask, state.radius, nn.pi, nn.pj,
                                     nn.row_off, nn.inc_start, nn.inc_pair, nodes.lim)
    kernels.require(x.device, x, state.prev_positions, state.inv_mass, state.mass,
                    state.node_mask, state.radius, nn.pi, nn.pj, nn.row_off, nn.inc_start,
                    nn.inc_pair, nodes.lim, failed)
    cap, lead = nodes.cap, x.shape[:-2]
    rows = min(cap, nn.pi.shape[-1])
    rec = torch.empty(lead + (rows, 8), dtype=torch.float32, device=x.device)
    imp = torch.empty_like(x)
    sums = torch.zeros(x.shape[:-1] + (4,), dtype=torch.float32, device=x.device) if acc \
        else None
    touching = torch.empty(lead + (1,), dtype=torch.int32, device=x.device)
    h, _ = _h_h2(params)
    err = kernels.lib().pies_node_friction(
        x.data_ptr(), state.prev_positions.data_ptr(), state.inv_mass.data_ptr(),
        state.mass.data_ptr(), state.node_mask.data_ptr(), state.radius.data_ptr(),
        nn.pi.data_ptr(), nn.pj.data_ptr(), nn.row_off.data_ptr(), nn.inc_start.data_ptr(),
        nn.inc_pair.data_ptr(), nodes.lim.data_ptr(), rec.data_ptr(), imp.data_ptr(),
        kernels.ptr(sums), touching.data_ptr(), failed.data_ptr(), x.shape[-2], rows,
        nn.pi.shape[-1], h, params.damping, params.gravity, params.friction,
        params.static_friction_threshold, members, kernels.stream())
    kernels.check(err, "node_friction")
    assembly.node_terms.launches += 1
    return (sums if acc else imp), touching


def substep_tail_plain(state: SolverState, topo: Topology, params: PhysicsParams,
                       active: torch.Tensor, x: torch.Tensor,
                       static_proj: torch.Tensor, colls: CollisionSet | None = None,
                       inc: Incidence | None = None,
                       fric: torch.Tensor | None = None,
                       floor_counts: torch.Tensor | None = None,
                       nn_imp: torch.Tensor | None = None, fric_all: bool = False) -> None:
    """Plain twin of kernel T4 — the dense-floor rest of
    ``pd._finish_substep`` — in place on ``state``: floor snap, velocity,
    the node-node friction impulse ``nn_imp`` (T27), then the contact
    friction impulse ``fric`` at nodes with point-triangle entries (when
    ``colls`` has live contacts), floor friction, ``positions = prev = x``,
    gravity forces, and the OR of the detection's capacity latch
    (``colls.overflow``) and of non-finite positions into latch slot 1.
    Nothing changes when latch slot 0 is set (a skipped tick).
    ``floor_counts`` (the entry-list floor's
    live entries per node) are the floor friction's exponents; ``active`` is
    then the entry list's snap flag.  ``fric_all``: ``fric`` is added at
    every node (the domain decomposition's halo-reduced friction, zero where
    a node has no contact).  An ensemble runs member by member."""
    if state.members:
        return each_member(
            lambda s, a, xx, sp, c, i, f, fc, nn: substep_tail_plain(s, topo, params, a, xx, sp,
                                                                     c, i, f, fc, nn, fric_all),
            state.members, state, active, x, static_proj, colls, inc, fric, floor_counts, nn_imp)
    floor = CollisionSet(floor_active=active, floor_counts=floor_counts)
    # Hard snap of floor contacts to the stale static projection
    # (Solver.cpp:379-382).
    x = torch.where(floor.floor_active[:, None] > 0, static_proj, x)
    forces = torch.zeros_like(x)
    forces[:, 1] = (-params.gravity * state.mass) * state.node_mask
    vel = base_velocity(x, state.prev_positions, state, params)
    if nn_imp is not None:
        vel = vel + nn_imp
    overflow = torch.zeros(1, dtype=torch.int32, device=x.device)
    if fric_all:
        vel = vel + fric
    elif colls is not None and colls.pt_idx is not None:
        on = (incident(inc) & (colls.pt_count[0] > 0))[:, None]
        vel = torch.where(on, vel + fric, vel)
    if colls is not None and colls.overflow is not None:
        overflow = colls.overflow
    vel = _static_floor_friction(vel, floor, params, topo.floor_count)

    skip = state.sim_failed[0] != 0
    for old, new in ((state.positions, x), (state.prev_positions, x),
                     (state.velocities, vel), (state.forces, forces)):
        old.copy_(torch.where(skip, old, new))
    bad = (~torch.isfinite(x).all() | (overflow[0] != 0)) & ~skip
    state.sim_failed[1:2].bitwise_or_(bad.to(torch.int32))


def substep_tail(state: SolverState, topo: Topology, params: PhysicsParams,
                 active: torch.Tensor, x: torch.Tensor,
                 static_proj: torch.Tensor, colls: CollisionSet | None = None,
                 inc: Incidence | None = None,
                 fric: torch.Tensor | None = None,
                 floor_counts: torch.Tensor | None = None,
                 nn_imp: torch.Tensor | None = None, fric_all: bool = False) -> None:
    """Kernel T4 on a CUDA state, :func:`substep_tail_plain` on a CPU state."""
    pos = state.positions
    if kernels.on_cpu(pos):
        return substep_tail_plain(state, topo, params, active, x, static_proj, colls,
                                  inc, fric, floor_counts, nn_imp, fric_all)
    pt = colls is not None and colls.pt_idx is not None and not fric_all
    row_start, pt_count = (inc.row_start, colls.pt_count) if pt else (None, None)
    fric = fric if pt or fric_all else None
    overflow = colls.overflow if colls is not None else None
    kernels.require(pos.device, pos, state.prev_positions, state.velocities,
                    state.forces, x, static_proj, active, topo.floor_count,
                    state.inv_mass, state.mass, state.node_mask, state.sim_failed,
                    fric, row_start, pt_count, overflow, floor_counts, nn_imp)
    h, _ = _h_h2(params)
    err = kernels.lib().pies_substep_tail(
        pos.data_ptr(), state.prev_positions.data_ptr(),
        state.velocities.data_ptr(), state.forces.data_ptr(), x.data_ptr(),
        static_proj.data_ptr(), active.data_ptr(), topo.floor_count.data_ptr(),
        state.inv_mass.data_ptr(), state.mass.data_ptr(),
        state.node_mask.data_ptr(), state.capacity, h, params.damping,
        params.gravity, params.friction, params.static_friction_threshold,
        state.sim_failed.data_ptr(), kernels.ptr(fric), kernels.ptr(row_start),
        kernels.ptr(pt_count), kernels.ptr(overflow), kernels.ptr(floor_counts),
        kernels.ptr(nn_imp), max(state.members, 1), kernels.stream(),
    )
    kernels.check(err, "substep_tail")
    substep_tail.launches += 1


substep_tail.launches = 0


_KERNELS = dict(head=substep_head, floor=floor_entries,
                cols=tetcols.substep_cols, contact=tetcols.contact_substep,
                setup=tetcols.pt_coupling_setup,
                pt_force=tetcols.pt_force, pt_tail=pt_tail, tail=substep_tail,
                block=assembly.tet_block_factor, assemble=assembly.assemble_force,
                pcg=assembly.pcg_solve, edge_setup=assembly.edge_setup,
                node_setup=assembly.node_setup, node_friction=node_friction)
_PLAIN = dict(head=substep_head_plain, floor=floor_entries_plain,
              cols=tetcols.substep_cols_plain, contact=tetcols.contact_substep_plain,
              setup=tetcols.pt_coupling_setup_plain,
              pt_force=tetcols.pt_force_plain, pt_tail=pt_tail_plain, tail=substep_tail_plain,
              block=assembly.tet_block_factor_plain, assemble=assembly.assemble_force_plain,
              pcg=assembly.pcg_solve_plain, edge_setup=assembly.edge_setup_plain,
              node_setup=assembly.node_setup_plain, node_friction=node_friction_plain)


COUNTERS = ("floor_active", "contacts", "rebuilds", "cg_trips", "edge_contacts", "edge_hits",
            "node_pairs", "touching_pairs")


def new_counters(device, members: int = 0) -> dict[str, torch.Tensor]:
    """Zeroed device counters for :func:`pd_substep`: floor-active nodes,
    live point-triangle contacts, broadphase cache rebuilds, CG trips, live
    edge-edge contacts and their hits before the cap, live node pairs and
    touching node pairs, each summed over substeps; i64[members] for an
    ensemble."""
    shape = (members,) if members else ()
    return {name: torch.zeros(shape, dtype=torch.int64, device=device) for name in COUNTERS}


def block_layout(state: SolverState, topo: Topology) -> bool:
    """Whether the disjoint-tet block layout covers the capacity, so the
    generic path's CG takes the exact block preconditioner
    (``pd.py:140-147``)."""
    return topo.tet_block6 is not None and topo.tet_block6.shape[-1] * 4 == state.capacity


def _generic_substep(state: SolverState, topo: Topology, params: PhysicsParams,
                     config: StepConfig, k: dict, head, floor, counters,
                     plain: bool) -> torch.Tensor:
    """The detection, PD iterations and tail of :func:`pd_substep` on the
    generic path (``pd.py:76-99,124-147,184-313``): with self-contact on, the
    point-triangle detection and T7's setup (the node incidence, the
    contacts' diagonal folded into the system diagonal and, unless the
    coupling is full, into the operator's dense diagonal); with node-node
    contacts, T20's fresh pair prefix and T27's setup (the pairs'
    diagonal, in both diagonals); with edge-edge contacts, T16 and T25's
    detection and T26's setup (the incidence, the edges' diagonal: in the
    system diagonal, and off full coupling in the operator's and the lag
    term); T22's block factor of the system diagonal where the disjoint-tet
    layout covers the capacity; then each iteration's local step (T12, T13,
    T9's stage 1; T7's contact force under recentered coupling), force
    (T9's stage 2, with T23's stacked contact force under full coupling,
    T26's edge and T27's pair terms, and the entry-list floor's per-entry
    sum when ``floor`` is given) and PCG solve warm-started from the iterate
    (T10/T11, with T23's and T26's contact blocks under full coupling),
    with the last local step's static projection kept for the floor snap
    and the shape rotations updated in place on the state; then T8 (the
    point-triangle and edge stabilization), T27's friction, T8's
    point-triangle friction and T4.  A substep without a live contact adds
    exact zeros, which is the JAX package's contact-free loop."""
    x, msn_h2, diag, wf, active = head
    failed = state.sim_failed
    _, h2 = _h_h2(params)
    plane = floor_plane(params, config.reference_quirks)
    inc = ptd = fric = pt = full = edges = nodes = nn_imp = colls = None
    full_coupling = config.contact_coupling == "full"
    pt_on, edge_on = self_contact(config, topo), edge_contact(config, topo)
    node_on = config.enable_node_collisions
    if pt_on:
        colls = detect_point_tri(state, x, topo, params, config, active, plain)
        if counters is not None:
            counters["contacts"].add_(colls.pt_count[..., 0])
            counters["rebuilds"].add_(colls.rebuilt[..., 0])
    elif edge_on or node_on:
        colls = CollisionSet(floor_active=active, overflow=torch.zeros(
            x.shape[:-2] + (1,), dtype=torch.int32, device=x.device))
    if edge_on:
        (colls.edge_idx, colls.edge_mask, colls.edge_count,
         colls.edge_hits) = broadphase.detect_edge_edge_collisions(
            x, state.prev_positions, topo.triangles, topo.tri_mask, params, config,
            colls.overflow, failed, plain)
        if counters is not None:
            counters["edge_contacts"].add_(colls.edge_count[..., 0])
            counters["edge_hits"].add_(colls.edge_hits[..., 0])
    if node_on:
        colls.nn = broadphase.detect_node_node_pairs(x, state.radius, state.node_mask, params,
                                                     config, failed, plain)
        colls.nn_cap = config.budget.max_node_node_contacts
    # The operator's dense diagonal: the floor weight, with the pairs'
    # diagonal and, off full coupling, the contacts' diagonals.
    static_diag = wf
    if node_on or (not full_coupling and (pt_on or edge_on)):
        static_diag = wf.clone()
    sd = None if static_diag is wf else static_diag
    if pt_on:
        inc, ptd = k["setup"](colls, state.mass, topo, h2, diag, wf, failed,
                              None if full_coupling else sd)
        if full_coupling:
            full = assembly.FullCoupling(colls, inc, params.collision_thickness)
    if node_on:
        nodes = k["node_setup"](colls.nn, colls.nn_cap, state.mass, state.radius,
                                state.inv_mass, topo, h2, diag, wf, failed, sd, inc, ptd,
                                not full_coupling, colls.pt_count)
        if counters is not None:
            counters["node_pairs"].add_(nodes.lim[..., 0])
    if edge_on:
        edges = k["edge_setup"](colls, state.mass, state.inv_mass, topo, h2, diag, wf,
                                params.collision_thickness, config.reference_quirks,
                                full_coupling, failed, sd, inc, ptd, nodes, colls.pt_count)
    block = k["block"](diag, topo.tet_block6, failed) if block_layout(state, topo) else None
    x_it, static_proj = x, torch.zeros_like(x)
    prr = torch.zeros(x.shape[:-2] + (1,), dtype=x.dtype, device=x.device)
    for _ in range(config.iterations):
        rows = assembly.local_step(x_it, state.inv_mass, state.mass, state.shape_quats, topo,
                                   config.rotation_iterations, failed, plain)
        if pt_on and not full_coupling:
            contact = k["pt_force"](x_it, colls, inc, params.collision_thickness, failed)
            pt = (ptd, contact, inc.row_start, colls.pt_count)
        force, static_proj = k["assemble"](x_it, msn_h2, wf, rows, topo, plane, failed, pt,
                                           full, floor, edges, nodes)
        x_it, prr, trips = k["pcg"](force, x_it, diag, state.mass, static_diag, h2,
                                    state.node_mask, topo, config.cg_iterations,
                                    config.cg_rtol, failed, block, full, edges)
        if counters is not None:
            counters["cg_trips"].add_(trips[..., 0])
    if pt_on or edge_on:
        stages = STABILIZE if node_on else STABILIZE | FRICTION
        fric = k["pt_tail"](state, params, config, colls, inc, x_it, static_proj, edges,
                            None, stages)
    if node_on:
        nn_imp, touching = k["node_friction"](x_it, state, params, nodes, failed)
        if counters is not None:
            counters["touching_pairs"].add_(touching[..., 0])
        if pt_on:
            fric = k["pt_tail"](state, params, config, colls, inc, x_it, static_proj, None,
                                nn_imp, FRICTION)
    k["tail"](state, topo, params, active, x_it, snap_target(config, x_it, static_proj), colls,
              inc, fric, None if floor is None else floor.floor_counts, nn_imp)
    return torch.sqrt(torch.sum(prr, dim=-1))


def pd_substep(state: SolverState, topo: Topology, params: PhysicsParams,
               config: StepConfig, fold: bool, plain: bool = False,
               counters: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """One PD substep on the tet-column or the generic path, in place on
    ``state``; returns the device-side residual of its last iteration
    (``‖b − A·x‖`` of the block solve, or of the last CG), f32[B] for an
    ensemble (0 for a latched member).

    ``plain=True`` runs the plain twins whatever the device (the card's
    reference run); otherwise each wrapper picks the kernel for a CUDA state
    and the twin for a CPU state.  ``counters`` (from :func:`new_counters`)
    are summed on the device, never read here: one small reduction or add
    per counter and substep."""
    k = _PLAIN if plain else _KERNELS
    head = k["head"](state, topo, params, config, fold)
    x, msn_h2, diag, wf, active = head
    failed = state.sim_failed
    colls = inc = fric = floor = None
    if not config.dense_floor and topo.corner_inc is not None:  # (no triangle: no entry)
        wf, floor = k["floor"](x, topo, params, config, diag, failed)
        active = floor.floor_active
        head = (x, msn_h2, diag, wf, active)
    if counters is not None:
        # A latched member's (or scene's) substep is skipped: the kernels
        # leave its outputs unwritten, and it counts nothing.
        live = failed[..., 0] == 0
        counters["floor_active"].add_(torch.where(live, active.sum(-1), 0.0).to(torch.int64))
    if not tetcols.applies(state, topo, config):
        return _generic_substep(state, topo, params, config, k, head, floor, counters, plain)
    if self_contact(config, topo):
        colls = detect_point_tri(state, x, topo, params, config, active, plain)
        if counters is not None:
            counters["contacts"].add_(colls.pt_count[..., 0])
            counters["rebuilds"].add_(colls.rebuilt[..., 0])
        _, h2 = _h_h2(params)
        inc, ptd = k["setup"](colls, state.mass, topo, h2, diag, wf, failed)
    args = (msn_h2, diag, state.node_mask, wf)
    plane = floor_plane(params, config.reference_quirks)
    if colls is None or config.iterations == 0:
        x_new, static_proj, r2 = k["cols"](x, *args, topo, plane, config.iterations,
                                           failed)
    else:  # (T7's force at each iteration's iterate, inside T2)
        x_new, static_proj, r2 = k["contact"](x, *args, topo, plane, config.iterations,
                                              failed, ptd, colls, inc,
                                              params.collision_thickness)
    if colls is not None:
        fric = k["pt_tail"](state, params, config, colls, inc, x_new, static_proj)
    k["tail"](state, topo, params, active, x_new, snap_target(config, x_new, static_proj), colls,
              inc, fric)
    return torch.sqrt(torch.sum(r2, dim=-1))
