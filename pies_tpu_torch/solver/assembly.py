"""PD global system: diagonals, and the generic path's local step, force,
operator and preconditioned CG (port of ``pies_tpu/solver/assembly.py:72-335,
338-368,448-725`` for the ported scenes), with the point-triangle
coupling in its three modes: recentered and diagonal (the contacts'
diagonal in the operator and the preconditioner, their force and lag term
in the right-hand side) and full (the contacts' whole blocks in the
operator and their stacked force, kernel T23), and the floor in its dense
and entry-list forms.

The tet-column path solves its 4x4 blocks directly and needs only the
diagonals.  The generic path, for every other scene, runs per PD iteration:

* :func:`local_step` — every constraint family's force rows ``w·AᵀB·p``
  into one row buffer: T12 (distance, bend), T13 (shape, goal) and T9's
  stage 1 (tets), see ``constraints/projections.py``;
* T9's stage 2 :func:`assemble_force` — ``((M·sₙ/h² + pin force) + the
  node's rows, in the JAX scatters' order) + w_f·p_static`` and the static
  projection;
* T10 :func:`apply_system` — ``(M/h² + w_f)·x + static_w·x + Σ coef·x[nbr]``
  over the assembled operator (ELL, or CSR for very wide rows), with a
  banded soup's tets as seven diagonals before it, and under full coupling
  the contacts' blocks after it (T23);
* T11 :func:`pcg_solve` — the PCG with the JAX package's trip cap and early
  exit, each trip one T10 launch and two T11 launches; Jacobi, or on a
  disjoint tet soup the exact 4x4 block preconditioner, whose factor is
  T22's (:func:`tet_block_factor`) and whose solve runs in T11's stages.

Each has a plain twin (``*_plain``).  The CG's dot products are summed in
the kernels' fixed block order (:func:`block_partials`, :func:`finalize`),
so kernel and twin agree bit for bit; against the JAX package (whose sums
XLA orders) they agree to float32 roundoff.

An ensemble (ROADMAP item 10b-i: the generic tick under ``jax.vmap``,
``pies_tpu/parallel/ensemble.py:41-50``) passes its per-member values with
a leading member axis B (positions, diagonals, rows, the CG's vectors,
partials and trip counts ``i32[B, 1]``) and shares the topology: each
kernel launches once for all members, and each twin runs member by member
(``state.each_member``).  The CG's exit is per member, as ``vmap`` of its
``while_loop`` makes it: a member stops at its own trip, and its result is
its single-scene solve's.  The point-triangle contact terms (T7's force
and lag, T23's blocks and stacked force) and the entry-list floor's force
(T24's mask) are per member too (ROADMAP item 10b-ii), and so are the
edge-edge and node-node terms (T26's setup, force and blocks, T27's setup
and force; item 10b-iii).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..collision.batches import (
    ATA_DIAG4,
    ATA_DIFF4,
    W_EDGE,
    W_NODE_NODE,
    W_POINT_TRI,
    W_STATIC,
    CollisionSet,
    Incidence,
    ata_rows,
    csr_sum,
    incidence_plain,
    incident,
    node_pairs_of,
    project_edge_edge,
    project_node_node,
    project_point_tri,
    project_static,
)
from ..constraints import projections as proj
from ..ops.math3d import ieee_div as _div
from ..state import each_member, member, members_of
from ..topology import Topology, row_layout

CG_BLOCK = 256  # pies::kCgBlock in kernels/csrc/cg_reduce.cuh


def static_collision_diag(colls: CollisionSet, floor_count: torch.Tensor,
                          corner_inc: Incidence | None = None) -> torch.Tensor:
    """Per-node diagonal of the floor-contact constraints (diagonal-only,
    ``CollisionConstraint.cpp:442-445``; ``assembly.py:338-353``): count · w
    · active on the dense floor, else the sum of ``w·static_mask`` over the
    node's entries through the corner incidence."""
    if colls.static_mask is None:
        return W_STATIC * floor_count * colls.floor_active
    return csr_sum(corner_inc, (W_STATIC * colls.static_mask)[:, None])[:, 0]


def point_tri_collision_diag(pt_idx: torch.Tensor, pt_mask: torch.Tensor, num_nodes: int,
                             inc: Incidence | None = None) -> torch.Tensor:
    """Dense per-node ``w·(AᵀA)ᵢᵢ`` of the point-triangle contacts (the
    recentered coupling's diagonal), summed per node in the JAX package's
    scatter order.  ``inc`` defaults to every entry of the buffer."""
    if inc is None:
        count = torch.full((1,), pt_idx.shape[0], dtype=torch.int32, device=pt_idx.device)
        inc = incidence_plain(pt_idx, count, num_nodes)
    wk = W_POINT_TRI * pt_mask
    vals = torch.cat([wk * float(ATA_DIFF4[a, a]) for a in range(4)])[:, None]
    return csr_sum(inc, vals)[:, 0]


def system_diag(mass_over_h2: torch.Tensor, topo: Topology,
                colls: CollisionSet) -> torch.Tensor:
    """The assembled diagonal of the PD system with this substep's floor
    contacts (``Solver.cpp:179-210,242-259``); the point-triangle term is
    folded in between the two sums by ``tetcols.pt_coupling_setup``."""
    diag = mass_over_h2 + topo.stiffness_diag
    return diag + static_collision_diag(colls, topo.floor_count, topo.corner_inc)


@dataclass
class FullCoupling:
    """The live contacts of full coupling for T9's stage 2 and T10: the
    detection's contacts, T7's incidence of them, the thickness."""

    colls: CollisionSet
    inc: Incidence
    thickness: float


class FusedLaunches:
    """The launch count of a kernel whose device functions run inside other
    kernels' launches: one per launch that carries them."""

    def __init__(self):
        self.launches = 0


pt_full = FusedLaunches()  # T23: the T9 stage 2 and T10 launches under full coupling


# ---------------------------------------------------------------------------
# T26 and T27: the edge-edge and node-node contacts' setup


@dataclass
class EdgeTerms:
    """T26's live edge contacts for T8, T9's stage 2 and T10: the
    detection's buffer, its row-major incidence (``e = 4·i + a``), the
    per-node diagonal ``ed`` (the sum of ``w·(AᵀA)ₐₐ`` over the node's
    entries, written at nodes with entries), and what the terms read.  An
    ensemble's tensors (the incidence's too) have a leading member axis."""

    edge_idx: torch.Tensor  # i32[E, 4]
    edge_mask: torch.Tensor  # f32[E]
    count: torch.Tensor  # i32[1]
    inc: Incidence
    ed: torch.Tensor  # f32[N]
    inv_mass: torch.Tensor
    thickness: float
    quirks: bool
    full: bool  # full coupling: the operator's blocks and the stacked force


@dataclass
class NodeTerms:
    """T27's live node pairs for T9's stage 2 and the friction: the pair
    prefix (``state.NodePairCache`` from T20, its incidence ``row_off``,
    ``inc_start``, ``inc_pair``) of which the first ``lim = min(count,
    cap)`` pairs are live, and the per-node diagonal ``nnd`` (written at
    nodes with live pairs).  An ensemble's tensors (the cache's too) have
    a leading member axis."""

    nn: object
    cap: int
    lim: torch.Tensor  # i32[1]
    nnd: torch.Tensor  # f32[N]
    radius: torch.Tensor
    inv_mass: torch.Tensor


edge_terms = FusedLaunches()  # T26: its setup launches and the T8/T9/T10 launches carrying it
node_terms = FusedLaunches()  # T27: its setup and friction launches and the T9 launches carrying it


def _node_incidence(nodes: NodeTerms, n: int) -> Incidence:
    """The row-major incidence (``e = 2·p + c``) of the live pairs."""
    idx, _ = node_pairs_of(nodes.nn, nodes.cap)
    return incidence_plain(idx, nodes.lim, n, row_major=True)


def _base_diag(mass, topo: Topology, h2: float, pt_inc, ptd):
    """``m/h² + stiffness``, plus the point-triangle diagonal at nodes with
    point-triangle entries (the JAX order of ``system_diag``)."""
    base = _div(mass, h2) + topo.stiffness_diag
    if pt_inc is not None:
        base = torch.where(incident(pt_inc), base + ptd, base)
    return base


def node_setup_plain(nn, cap: int, mass, radius, inv_mass, topo: Topology, h2: float,
                     diag, wf, failed=None, static_diag=None, pt_inc: Incidence | None = None,
                     ptd=None, recentered: bool = False, pt_count=None) -> NodeTerms:
    """Plain twin of T27's setup: ``lim = min(count, cap)``, the pairs'
    diagonal ``nnd`` (``assembly.py:382-394``), and at nodes with live
    pairs ``diag = (((m/h² + stiffness) + ptd) + nnd) + wf`` and the
    operator's dense diagonal ``static_diag = (wf + nnd) + ptd`` (ptd only
    under recentered coupling; ``pd.py:83-99``), in place.  ``pt_inc``,
    ``ptd``, ``pt_count``: T7's incidence, diagonal and contact count (None
    without self-contact; the twin's incidence is empty without contacts,
    so ``pt_count`` is accepted for signature parity).  An ensemble (``mass``
    f32[B, N] and every per-node or per-pair argument with the member axis)
    runs member by member."""
    if mass.dim() == 2:
        return each_member(lambda nb, mb, rb, ib, db, wb, fb, sb, pb, qb, cb: node_setup_plain(
            nb, cap, mb, rb, ib, topo, h2, db, wb, fb, sb, pb, qb, recentered, cb),
            mass.shape[0], nn, mass, radius, inv_mass, diag, wf, failed, static_diag, pt_inc, ptd,
            pt_count)
    n = mass.shape[0]
    lim = torch.full((1,), min(int(nn.count[0]), cap), dtype=torch.int32, device=mass.device)
    terms = NodeTerms(nn, cap, lim, torch.zeros_like(mass), radius, inv_mass)
    inc = _node_incidence(terms, n)
    terms.nnd = csr_sum(inc, torch.full((2 * cap, 1), W_NODE_NODE, device=mass.device))[:, 0]
    if failed is None or not bool(failed[0]):
        on = incident(inc)
        full = (_base_diag(mass, topo, h2, pt_inc, ptd) + terms.nnd) + wf
        diag.copy_(torch.where(on, full, diag))
        if static_diag is not None:
            sd = wf + terms.nnd
            if recentered and pt_inc is not None:
                sd = torch.where(incident(pt_inc), sd + ptd, sd)
            static_diag.copy_(torch.where(on, sd, static_diag))
    return terms


def node_setup(nn, cap: int, mass, radius, inv_mass, topo: Topology, h2: float, diag, wf,
               failed=None, static_diag=None, pt_inc: Incidence | None = None, ptd=None,
               recentered: bool = False, pt_count=None) -> NodeTerms:
    """T27's setup on CUDA tensors, :func:`node_setup_plain` on CPU tensors.
    On the card ``nnd`` is written only at nodes with live pairs, and
    nothing when ``failed`` slot 0 is set (``lim`` is then 0); an ensemble
    is one launch for all members."""
    if kernels.on_cpu(mass):
        return node_setup_plain(nn, cap, mass, radius, inv_mass, topo, h2, diag, wf, failed,
                                static_diag, pt_inc, ptd, recentered, pt_count)
    if failed is None:
        raise ValueError("the node contact kernel needs the failure latch")
    dev = mass.device
    n = mass.shape[-1]
    pt_start = pt_inc.row_start if pt_inc is not None else None
    members = kernels.launch_members(nn.ref, failed, nn.pi, nn.count, nn.row_off, nn.inc_start,
                                     nn.inc_pair, mass, diag, wf, static_diag, pt_start,
                                     pt_count, ptd)
    kernels.require(dev, nn.pi, nn.count, nn.row_off, nn.inc_start, nn.inc_pair, mass,
                    topo.stiffness_diag, diag, wf, failed, static_diag, pt_start, pt_count, ptd)
    lead = mass.shape[:-1]
    lim = torch.empty(lead + (1,), dtype=torch.int32, device=dev)
    nnd = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    err = kernels.lib().pies_node_setup(
        nn.pi.data_ptr(), nn.count.data_ptr(), nn.row_off.data_ptr(), nn.inc_start.data_ptr(),
        nn.inc_pair.data_ptr(), mass.data_ptr(), topo.stiffness_diag.data_ptr(), wf.data_ptr(),
        diag.data_ptr(), kernels.ptr(static_diag), kernels.ptr(pt_start),
        kernels.ptr(pt_count), kernels.ptr(ptd), lim.data_ptr(), nnd.data_ptr(),
        failed.data_ptr(), n, cap, int(recentered), nn.pi.shape[-1], h2, members,
        kernels.stream())
    kernels.check(err, "node_setup")
    node_terms.launches += 1
    return NodeTerms(nn, cap, lim, nnd, radius, inv_mass)


def edge_setup_plain(colls: CollisionSet, mass, inv_mass, topo: Topology, h2: float, diag, wf,
                     thickness: float, quirks: bool, full: bool, failed=None,
                     static_diag=None, pt_inc: Incidence | None = None, ptd=None,
                     nodes: NodeTerms | None = None, pt_count=None) -> EdgeTerms:
    """Plain twin of T26's setup: the row-major incidence of the live
    edges, their diagonal ``ed`` (``assembly.py:371-380``) and, at nodes
    with edge entries, ``diag = ((((m/h² + stiffness) + ptd) + w·(AᵀA)ₐₐ of
    each entry in turn) + nnd) + wf`` (``assembly.py:577-598``) and the
    operator's dense diagonal ``static_diag = (wf + nnd) + (ptd + ed)``
    (``ptd + ed`` only off full coupling; ``pd.py:83-99``), in place.  An
    ensemble (``mass`` f32[B, N], ``colls``, ``nodes`` and every per-node
    argument with the member axis) runs member by member."""
    if mass.dim() == 2:
        return each_member(lambda cb, mb, ib, db, wb, fb, sb, pb, qb, nb, kb: edge_setup_plain(
            cb, mb, ib, topo, h2, db, wb, thickness, quirks, full, fb, sb, pb, qb, nb, kb),
            mass.shape[0], colls, mass, inv_mass, diag, wf, failed, static_diag, pt_inc, ptd,
            nodes, pt_count)
    n = mass.shape[0]
    inc = incidence_plain(colls.edge_idx, colls.edge_count, n, row_major=True)
    we = W_EDGE * colls.edge_mask
    vals = (we[:, None] * torch.tensor(ATA_DIAG4, device=mass.device)[None, :]).reshape(-1, 1)
    ed = csr_sum(inc, vals)[:, 0]
    if failed is None or not bool(failed[0]):
        on = incident(inc)
        acc = csr_sum(inc, vals, _base_diag(mass, topo, h2, pt_inc, ptd)[:, None])[:, 0]
        sd = wf
        if nodes is not None:
            nn_on = incident(_node_incidence(nodes, n))
            acc = torch.where(nn_on, acc + nodes.nnd, acc)
            sd = torch.where(nn_on, wf + nodes.nnd, wf)
        diag.copy_(torch.where(on, acc + wf, diag))
        if static_diag is not None:
            if not full:
                lag = ed if pt_inc is None else torch.where(incident(pt_inc), ptd + ed, ed)
                sd = sd + lag
            static_diag.copy_(torch.where(on, sd, static_diag))
    return EdgeTerms(colls.edge_idx, colls.edge_mask, colls.edge_count, inc, ed, inv_mass,
                     thickness, quirks, full)


def edge_setup(colls: CollisionSet, mass, inv_mass, topo: Topology, h2: float, diag, wf,
               thickness: float, quirks: bool, full: bool, failed=None, static_diag=None,
               pt_inc: Incidence | None = None, ptd=None,
               nodes: NodeTerms | None = None, pt_count=None) -> EdgeTerms:
    """T26's setup on CUDA tensors, :func:`edge_setup_plain` on CPU tensors.
    On the card ``ed`` is written only at nodes with edge entries, and
    nothing when ``failed`` slot 0 is set; an ensemble is one launch for
    all members."""
    if kernels.on_cpu(mass):
        return edge_setup_plain(colls, mass, inv_mass, topo, h2, diag, wf, thickness, quirks,
                                full, failed, static_diag, pt_inc, ptd, nodes, pt_count)
    if failed is None:
        raise ValueError("the edge contact kernel needs the failure latch")
    dev = mass.device
    n, cap = mass.shape[-1], colls.edge_idx.shape[-2]
    pt_start = pt_inc.row_start if pt_inc is not None else None
    nn = nodes.nn if nodes is not None else None
    nn_ptrs = ((nn.row_off, nn.inc_start, nn.inc_pair, nodes.lim, nodes.nnd)
               if nodes is not None else (None,) * 5)
    members = kernels.launch_members(colls.edge_idx, failed, colls.edge_mask, colls.edge_count,
                                     mass, diag, wf, static_diag, pt_start, pt_count, ptd,
                                     *nn_ptrs)
    kernels.require(dev, colls.edge_idx, colls.edge_mask, colls.edge_count, mass,
                    topo.stiffness_diag, diag, wf, failed, static_diag, pt_start, pt_count, ptd,
                    *nn_ptrs)
    lead = mass.shape[:-1]
    i32 = dict(dtype=torch.int32, device=dev)
    deg = torch.zeros(lead + (n,), **i32)
    row_start = torch.empty(lead + (n + 1,), **i32)
    partial = torch.empty(members * kernels.scan_partials(n), **i32)
    entries = torch.empty(lead + (4 * cap,), **i32)
    nodes_of = torch.empty(lead + (4 * cap,), **i32)
    ed = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    err = kernels.lib().pies_edge_setup(
        colls.edge_idx.data_ptr(), colls.edge_mask.data_ptr(), colls.edge_count.data_ptr(),
        mass.data_ptr(), topo.stiffness_diag.data_ptr(), wf.data_ptr(), diag.data_ptr(),
        kernels.ptr(static_diag), kernels.ptr(pt_start), kernels.ptr(pt_count),
        kernels.ptr(ptd), *(kernels.ptr(t) for t in nn_ptrs), deg.data_ptr(),
        row_start.data_ptr(), partial.data_ptr(), entries.data_ptr(), nodes_of.data_ptr(),
        ed.data_ptr(), failed.data_ptr(), n, cap, int(full),
        nn.pi.shape[-1] if nn is not None else 0, h2, members, kernels.stream())
    kernels.check(err, "edge_setup")
    edge_terms.launches += 1
    return EdgeTerms(colls.edge_idx, colls.edge_mask, colls.edge_count,
                     Incidence(row_start, entries, nodes_of, cap), ed, inv_mass, thickness,
                     quirks, full)


def edge_force_rows(x, edges: EdgeTerms) -> torch.Tensor:
    """Plain twin of T26's force term: per entry ``e = 4·i + a``, ``w·(AᵀA
    q)[a]`` with ``q`` the stack projection (full coupling) or its
    displacement (recentered), ``w = 1e6·mask`` (``assembly.py:305-318``).
    Returns f32[4E, 3]."""
    proj, delta = project_edge_edge(x, edges.inv_mass, edges.edge_idx, edges.thickness,
                                    edges.quirks)
    return ata_rows(proj if edges.full else delta, W_EDGE * edges.edge_mask).reshape(-1, 3)


def edge_operator_rows(x, edges: EdgeTerms) -> torch.Tensor:
    """Plain twin of T26's operator term under full coupling: per entry
    ``w·(AᵀA x)[a]`` (``assembly.py:559-574``).  Returns f32[4E, 3]."""
    return ata_rows(x[edges.edge_idx.long()], W_EDGE * edges.edge_mask).reshape(-1, 3)


def node_force_rows(x, nodes: NodeTerms) -> tuple[torch.Tensor, Incidence]:
    """Plain twin of T27's force term: per entry ``e = 2·p + c``, ``w·p`` of
    the pair's projection, ``w = 1e5·mask`` (``assembly.py:320-325``), with
    the row-major incidence of the live pairs."""
    idx, mask = node_pairs_of(nodes.nn, nodes.cap)
    proj = project_node_node(x, nodes.radius, nodes.inv_mass, idx)
    rows = ((W_NODE_NODE * mask)[:, None, None] * proj).reshape(-1, 3)
    return rows, _node_incidence(nodes, x.shape[0])


def pt_full_rows(q: torch.Tensor, pt_mask: torch.Tensor) -> torch.Tensor:
    """Plain twin of T23's per-entry term: ``w·(AᵀA q)[a]`` for each contact
    k's rows ``q`` f32[K, 4, 3] (its positions, or their stack projection),
    ``w = 1e4·mask``, as entry rows ``e = a·K + k`` f32[4K, 3]
    (``assembly.py:282-287,559-574``; the row's four terms summed in
    order)."""
    return ata_rows(q, W_POINT_TRI * pt_mask).transpose(0, 1).reshape(-1, 3)


def _add_full(v: torch.Tensor, x: torch.Tensor, full: FullCoupling, project: bool):
    """``v`` plus each node's T23 terms through the incidence, added one
    after another (nothing without live contacts)."""
    c = full.colls
    if int(c.pt_count[0]) == 0:
        return v
    q = (project_point_tri(x, c.pt_idx, full.thickness) if project
         else x[c.pt_idx.long()])
    return csr_sum(full.inc, pt_full_rows(q, c.pt_mask), v)


def _pins(topo: Topology) -> bool:
    return topo.position.idx.shape[0] > 0


def _static_w(topo: Topology, n: int):
    """The dense static weight, or None when the scene has no diagonal-only
    constraint."""
    return topo.static_w if topo.static_w.shape[0] == n else None


# ---------------------------------------------------------------------------
# the local step: every family's force rows


def local_step(x, inv_mass, mass, quats, topo: Topology, rotation_iterations: int,
               failed=None, plain: bool = False) -> torch.Tensor:
    """One PD iteration's local step (``assembly.py:72-173`` with the row
    construction of ``assemble_force``, ``:218-278``): every constraint is
    projected from the same positions ``x`` f32[N, 3], and its force rows
    ``w·AᵀB·p`` go to one buffer f32[R, 3] laid out by
    ``topology.row_layout``.  ``quats`` f32[G, 4], the shape groups'
    rotations, is updated in place.  A family without constraints launches
    nothing, as the JAX package elides it.  ``plain`` takes the twins
    whatever the device.  An ensemble's ``x`` f32[B, N, 3] (with its
    ``inv_mass``, ``mass``, ``quats`` and latch per member) fills f32[B, R,
    3], each family's part a member-major view."""
    lay = row_layout(topo)
    total = sum(rows for _, rows in lay.values())
    buf = torch.empty(x.shape[:-2] + (total, 3), dtype=torch.float32, device=x.device)

    def part(name):
        at, rows = lay[name]
        return buf[..., at:at + rows, :] if rows else None

    dist, bend, shape, goal, tets = (
        (proj.distance_rows_plain, proj.bend_rows_plain, proj.shape_rows_plain,
         proj.goal_rows_plain, proj.tet_force12_gathered_plain) if plain else
        (proj.distance_rows, proj.bend_rows, proj.shape_rows, proj.goal_rows,
         proj.tet_force12_gathered))
    if (out := part("distance")) is not None:
        dist(x, topo.distance, failed, out)
    if topo.tet_fused:
        if (out := part("strain")) is not None:
            tets(x, topo.strain, topo.volume, failed, out, "fused")
    else:
        for kind in ("strain", "volume"):
            if (out := part(kind)) is not None:
                tets(x, topo.strain, topo.volume, failed, out, kind)
    if (out := part("bend")) is not None:
        bend(x, inv_mass, topo.bend, failed, out)
    if (out := part("shape")) is not None:
        shape(x, mass, quats, topo.shape, rotation_iterations, failed, out)
    if (out := part("goal")) is not None:
        goal(topo.goal, failed, out)
    return buf


# ---------------------------------------------------------------------------
# T9 stage 2: the force


def assemble_force_plain(x, msn_h2, wf, blocks, topo: Topology, plane: float,
                         failed=None, pt=None, full: FullCoupling | None = None,
                         floor: CollisionSet | None = None, edges: EdgeTerms | None = None,
                         nodes: NodeTerms | None = None):
    """Plain twin of T9's stage 2.  ``x`` f32[N, 3] is the iterate, ``msn_h2``
    its ``M·sₙ/h²``, ``wf`` f32[N] the floor weight, ``blocks`` f32[R, 3]
    the local step's force rows.  ``pt`` (or None) is ``(ptd f32[N], contact
    f32[N, 3], row_start i32[N+1], pt_count i32[1])``, the recentered
    point-triangle coupling (``assembly.py:288-303``): when contacts are
    live, each node with contact entries adds ``contact`` (its sum of
    ``w·AᵀA[:, 0]·delta``) and then ``ptd·x`` (elsewhere both are exact
    zeros, and the arrays there are not read).  ``full`` (full coupling,
    ``assembly.py:282-287``): each node adds ``w·AᵀA·p`` over its contact
    entries, ``p`` the stack projection (T23).  ``floor`` (the entry-list
    floor's ``CollisionSet``, ``:332-334``): the floor term is ``w·static``
    per corner entry, ``w = 1e4·static_mask``, instead of ``wf·static``.
    ``edges`` (T26): off full coupling, nodes with edge entries add
    ``ed·x`` to the lag term (``ptd + ed``, ``pd.py:91-99``); then each
    node adds its edge entries' terms (:func:`edge_force_rows`).
    ``nodes`` (T27): each node adds its pair entries' ``w·p``.
    Returns ``(force, static)`` f32[N, 3]: the right side ``((((msn + pin
    force) + Σ the node's rows) + contact + (ptd + ed)·x) + edge and pair
    terms) + wf·static`` and the floor projection ``static = (x, max(y,
    plane), z)``.  ``failed`` is accepted for signature parity.  An
    ensemble (``x``, ``msn_h2`` f32[B, N, 3], ``wf`` f32[B, N], ``blocks``
    f32[B, R, 3], and ``pt``, ``full``, ``floor``, ``edges`` and ``nodes``
    with the member axis) runs member by member."""
    if members_of(x):
        return each_member(lambda xb, mb, wb, bb, pb, fb, lb, eb, nb: assemble_force_plain(
            xb, mb, wb, bb, topo, plane, None, pb, fb, lb, eb, nb),
            members_of(x), x, msn_h2, wf, blocks, pt, full, floor, edges, nodes)
    f = msn_h2 + topo.position_force_dense if _pins(topo) else msn_h2
    f = csr_sum(topo.row_inc, blocks, f)
    lag_on = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    lag = torch.zeros_like(wf)
    if pt is not None:
        ptd, contact, row_start, pt_count = pt
        lag_on = (row_start[1:] > row_start[:-1]) & (pt_count[0] > 0)
        f = torch.where(lag_on[:, None], f + contact, f)
        lag = torch.where(lag_on, ptd, lag)
    if edges is not None and not edges.full:
        e_on = incident(edges.inc)
        lag = torch.where(e_on, lag + edges.ed, lag)
        lag_on = lag_on | e_on
    f = torch.where(lag_on[:, None], f + lag[:, None] * x, f)
    if full is not None:
        f = _add_full(f, x, full, project=True)
    if edges is not None:
        f = csr_sum(edges.inc, edge_force_rows(x, edges), f)
    if nodes is not None:
        rows, inc = node_force_rows(x, nodes)
        f = csr_sum(inc, rows, f)
    y = x[:, 1]
    static = torch.stack([x[:, 0], torch.where(y < plane, plane, y), x[:, 2]], dim=1)
    if floor is not None:
        vals = (W_STATIC * floor.static_mask)[:, None] * project_static(x, floor.static_idx,
                                                                        plane)
        return csr_sum(topo.corner_inc, vals, f), static
    return f + wf[:, None] * static, static


def assemble_force(x, msn_h2, wf, blocks, topo: Topology, plane: float, failed=None,
                   pt=None, full: FullCoupling | None = None,
                   floor: CollisionSet | None = None, edges: EdgeTerms | None = None,
                   nodes: NodeTerms | None = None):
    """T9's stage 2 on CUDA tensors, :func:`assemble_force_plain` on CPU
    tensors.  On the card ``failed`` is required."""
    if kernels.on_cpu(x):
        return assemble_force_plain(x, msn_h2, wf, blocks, topo, plane, failed, pt, full,
                                    floor, edges, nodes)
    if failed is None:
        raise ValueError("the force kernel needs the failure latch")
    inc = topo.row_inc
    n = x.shape[-2]
    pin = topo.position_force_dense if _pins(topo) else None
    if pin is not None and pin.shape[0] != n:
        raise ValueError("pin force must be dense over the capacity")
    if inc.row_start.shape[0] != n + 1 or blocks.shape[-2] != inc.entries.shape[0]:
        raise ValueError("the row incidence does not match the nodes or the force rows")
    ptd, contact, pt_start, pt_count = pt if pt is not None else (None,) * 4
    pt_idx = pt_mask = pt_entries = None
    cap, thickness = 0, 0.0
    if full is not None:
        pt_idx, pt_mask, pt_count = full.colls.pt_idx, full.colls.pt_mask, full.colls.pt_count
        pt_start, pt_entries, cap, thickness = (full.inc.row_start, full.inc.entries,
                                                full.inc.cap, full.thickness)
    c_start = c_entries = smask = None
    if floor is not None:
        c_start, c_entries = topo.corner_inc.row_start, topo.corner_inc.entries
        smask = floor.static_mask
    members = kernels.launch_members(x, failed, msn_h2, wf, blocks, ptd, contact, pt_start,
                                     pt_count, pt_idx, pt_mask, pt_entries, smask,
                                     *_terms_arrays(edges, nodes))
    if smask is not None and smask.shape[-1] != c_entries.shape[0]:
        raise ValueError("the floor entries' mask needs a row of corner entries per member")
    kernels.require(x.device, x, msn_h2, pin, wf, inc.row_start, inc.entries, blocks, failed,
                    ptd, contact, pt_start, pt_count, pt_idx, pt_mask, pt_entries, c_start,
                    c_entries, smask)
    force, static = torch.empty_like(x), torch.empty_like(x)
    err = kernels.lib().pies_assemble_force(
        x.data_ptr(), msn_h2.data_ptr(), kernels.ptr(pin), wf.data_ptr(),
        inc.row_start.data_ptr(), inc.entries.data_ptr(), blocks.data_ptr(),
        force.data_ptr(), static.data_ptr(), n, float(plane), failed.data_ptr(),
        kernels.ptr(ptd), kernels.ptr(contact), kernels.ptr(pt_start),
        kernels.ptr(pt_count), kernels.ptr(pt_idx), kernels.ptr(pt_mask),
        kernels.ptr(pt_entries), cap, float(thickness), kernels.ptr(c_start),
        kernels.ptr(c_entries), kernels.ptr(smask),
        c_entries.shape[0] if c_entries is not None else 0, *_edge_args(x.device, edges, True),
        *_node_args(x.device, nodes), blocks.shape[-2], members, kernels.stream(),
    )
    kernels.check(err, "assemble_force")
    assemble_force.launches += 1
    if full is not None:
        pt_full.launches += 1
    if edges is not None:
        edge_terms.launches += 1
    if nodes is not None:
        node_terms.launches += 1
    return force, static


def _terms_arrays(edges: EdgeTerms | None, nodes: NodeTerms | None) -> tuple:
    """The per-member arrays of the edge and pair terms, for the member
    axis checks."""
    e = () if edges is None else (edges.edge_idx, edges.edge_mask, edges.count,
                                  edges.inc.row_start, edges.inc.entries, edges.ed,
                                  edges.inv_mass)
    n = () if nodes is None else (nodes.nn.pi, nodes.nn.pj, nodes.nn.row_off,
                                  nodes.nn.inc_start, nodes.nn.inc_pair, nodes.lim,
                                  nodes.radius, nodes.inv_mass)
    return e + n


def _edge_args(device, edges: EdgeTerms | None, force: bool) -> tuple:
    """T26's arguments of T9's stage 2 (``force``) and T10: pointers (null
    without edges, and in T10 off full coupling), then the mode word (1 full
    coupling, 2 quirks), the thickness and a member's contact slots."""
    if edges is None or not (force or edges.full):
        return (None,) * 7 + (0, 0.0, 0)
    t = _terms_arrays(edges, None)
    kernels.require(device, *t)
    mode = int(edges.full) | (2 * int(edges.quirks))
    return tuple(x.data_ptr() for x in t) + (mode, float(edges.thickness),
                                             edges.edge_idx.shape[-2])


def _node_args(device, nodes: NodeTerms | None) -> tuple:
    """T27's arguments of T9's stage 2: pointers (null without pairs), then
    the cap and a member's pair slots."""
    if nodes is None:
        return (None,) * 8 + (0, 0)
    t = _terms_arrays(None, nodes)
    kernels.require(device, *t)
    return tuple(x.data_ptr() for x in t) + (nodes.cap, nodes.nn.pi.shape[-1])


assemble_force.launches = 0


# ---------------------------------------------------------------------------
# fixed-order reductions (kernels/csrc/cg_reduce.cuh)


def _dot3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2]


def _tree(w: torch.Tensor) -> torch.Tensor:
    """The 256-wide pairwise tree over the last axis: v[t] += v[t + s]."""
    s = CG_BLOCK // 2
    while s:
        w = w[..., :s] + w[..., s:2 * s]
        s //= 2
    return w[..., 0]


def block_partials(v: torch.Tensor) -> torch.Tensor:
    """Per-block sums f32[P] of per-node values f32[N], blocks of 256 nodes
    (0 past N), each by the kernels' pairwise tree."""
    n = v.shape[0]
    p = -(-n // CG_BLOCK)
    w = torch.zeros(p * CG_BLOCK, dtype=v.dtype, device=v.device)
    w[:n] = v
    return _tree(w.view(p, CG_BLOCK)).contiguous()


def finalize(part: torch.Tensor) -> torch.Tensor:
    """The total (a 0-d tensor) of block partials f32[P] in the kernels'
    order: lane t sums part[t], part[t + 256], ... (0 past P), then the
    tree."""
    p = part.shape[0]
    k = -(-p // CG_BLOCK)
    w = torch.zeros(k * CG_BLOCK, dtype=part.dtype, device=part.device)
    w[:p] = part
    w = w.view(k, CG_BLOCK)
    acc = w[0]
    for j in range(1, k):
        acc = acc + w[j]
    return _tree(acc)


# ---------------------------------------------------------------------------
# T10: the operator


def _operator_sum(x, topo: Topology) -> torch.Tensor:
    """``Σ coef·x[col]`` per row of the assembled operator, the first term
    starting the sum and the others added in slot (ascending column) order;
    zero for an empty row."""
    if topo.csr_start is not None:
        start = topo.csr_start.long()
        deg = start[1:] - start[:-1]
        last = max(topo.csr_col.shape[0] - 1, 0)
        acc = torch.zeros_like(x)
        for s in range(int(deg.max())):
            live = deg > s
            at = torch.clamp_max(start[:-1] + s, last)
            term = torch.where(live, topo.csr_val[at], 0.0)[:, None] * x[topo.csr_col[at].long()]
            acc = term if s == 0 else torch.where(live[:, None], acc + term, acc)
        return acc
    nbr, coef = topo.ell_nbr, topo.ell_coef
    if nbr.shape[0] == 0:
        return torch.zeros_like(x)
    acc = coef[0][:, None] * x[nbr[0].long()]
    for s in range(1, nbr.shape[0]):
        acc = acc + coef[s][:, None] * x[nbr[s].long()]
    return acc


def _band(topo: Topology, n: int):
    """The tets' seven diagonals, or None off the banded layout."""
    band = topo.tet_band
    return band if band is not None and band.shape[1] == n else None


def _band_sum(x, band) -> torch.Tensor:
    """``Σ_d band[3 + d]·x[i + d]`` with wrap-around, in the JAX order
    (``assembly.py:498-501``): the diagonal, then for d = 1, 2, 3 the ``+d``
    term and the ``−d`` term."""
    acc = band[3][:, None] * x
    for d in (1, 2, 3):
        acc = acc + band[3 + d][:, None] * torch.roll(x, -d, 0)
        acc = acc + band[3 - d][:, None] * torch.roll(x, d, 0)
    return acc


def apply_system_plain(x, mass, wf, h2: float, topo: Topology, part: bool = False,
                       full: FullCoupling | None = None, edges: EdgeTerms | None = None):
    """Plain twin of T10: ``y = (mass/h² + wf)·x + static_w·x + the tets'
    band + Σₘ coef·x[nbr]`` (slot order) f32[N, 3]; ``wf`` is the substep's
    dense diagonal (the floor weight, plus the contacts' diagonal under
    recentered coupling); with ``full`` (full coupling) then each node's
    ``w·AᵀA·x`` over its contact entries (``assembly.py:559-574``, T23);
    then, with ``edges`` under full coupling, each node's ``w·AᵀA·x`` over
    its edge entries (T26); with ``part`` also the block partials of
    ``x·y``, else None.  An ensemble (``x`` f32[B, N, 3], ``mass`` and ``wf``
    f32[B, N], ``full`` and ``edges`` with the member axis) runs member by
    member: partials f32[B, P]."""
    if members_of(x):
        y, p = zip(*(apply_system_plain(x[b], mass[b], wf[b], h2, topo, part, member(full, b),
                                        member(edges, b))
                     for b in range(x.shape[0])))
        return torch.stack(y), (torch.stack(p) if part else None)
    y = (_div(mass, h2) + wf)[:, None] * x
    sw = _static_w(topo, x.shape[0])
    if sw is not None:
        y = y + sw[:, None] * x
    band = _band(topo, x.shape[0])
    if band is not None:
        y = y + _band_sum(x, band)
    y = y + _operator_sum(x, topo)
    if full is not None:
        y = _add_full(y, x, full, project=False)
    if edges is not None and edges.full:
        y = csr_sum(edges.inc, edge_operator_rows(x, edges), y)
    return y, (block_partials(_dot3(x, y)) if part else None)


def apply_system(x, mass, wf, h2: float, topo: Topology, failed=None,
                 part: bool | torch.Tensor = False, out=None, gate=None,
                 full: FullCoupling | None = None, edges: EdgeTerms | None = None):
    """T10 on CUDA tensors, :func:`apply_system_plain` on CPU tensors (same
    results).  On the card: ``failed`` is required; ``out`` (f32[N, 3]) and
    ``part`` (f32[P], or True for a new one) receive the results; ``gate``
    ``(trips, prz, prz0, trip, early_exit, rtol2)`` makes the launch CG trip
    ``trip`` of :func:`pcg_solve`, which returns at once after the exit."""
    if kernels.on_cpu(x):
        return apply_system_plain(x, mass, wf, h2, topo, part is not False, full, edges)
    if failed is None:
        raise ValueError("the operator kernel needs the failure latch")
    n = x.shape[-2]
    c, inc = (full.colls, full.inc) if full is not None else (None, None)
    pt = ((c.pt_idx, c.pt_mask, c.pt_count, inc.row_start, inc.entries) if full is not None
          else (None,) * 5)
    members = kernels.launch_members(x, failed, mass, wf, *pt, *_terms_arrays(edges, None))
    row_start = topo.csr_start
    if row_start is not None:
        nbr, coef, m = topo.csr_col, topo.csr_val, 0
        if row_start.shape[0] != n + 1 or nbr.shape != coef.shape:
            raise ValueError("the operator kernel needs the CSR over the capacity")
    else:
        nbr, coef = topo.ell_nbr, topo.ell_coef
        if nbr is None or nbr.shape != coef.shape or nbr.shape[1] != n:
            raise ValueError("the operator kernel needs the slot-major ELL over the capacity")
        m = nbr.shape[0]
    pin_w = _static_w(topo, n)
    band = _band(topo, n)
    y = torch.empty_like(x) if out is None else out
    if part is True:
        part = torch.empty(x.shape[:-2] + (-(-n // CG_BLOCK),), dtype=torch.float32,
                           device=x.device)
    part = part if isinstance(part, torch.Tensor) else None
    trips, prz, prz0, trip, early, rtol2 = gate if gate is not None else (None,) * 3 + (0, 0, 0.0)
    kernels.require(x.device, x, mass, wf, pin_w, band, row_start, nbr, coef, y, part, failed,
                    trips, prz, prz0, *pt)
    err = kernels.lib().pies_ell_matvec(
        x.data_ptr(), mass.data_ptr(), wf.data_ptr(), kernels.ptr(pin_w), kernels.ptr(band),
        kernels.ptr(row_start), nbr.data_ptr(), coef.data_ptr(), m, y.data_ptr(),
        kernels.ptr(part), n, float(h2),
        failed.data_ptr(), kernels.ptr(trips), kernels.ptr(prz), kernels.ptr(prz0),
        int(trip), int(early), float(rtol2), *(kernels.ptr(t) for t in pt),
        inc.cap if inc is not None else 0, *_edge_args(x.device, edges, False), members,
        kernels.stream(),
    )
    kernels.check(err, "ell_matvec")
    apply_system.launches += 1
    if full is not None:
        pt_full.launches += 1
    if edges is not None and edges.full:
        edge_terms.launches += 1
    return y, part


apply_system.launches = 0


# ---------------------------------------------------------------------------
# T11: Jacobi-PCG


def _rtol2(rtol: float) -> float:
    """``rtol·rtol`` as the float32 the JAX package multiplies ``rz0`` by."""
    return float(np.float32(rtol * rtol))


def pcg_solve_plain(b, x0, diag, mass, wf, h2: float, mask, topo: Topology,
                    iterations: int, rtol: float = 0.0, failed=None, block=None,
                    full: FullCoupling | None = None, edges: EdgeTerms | None = None,
                    matvec=None, ranks=None):
    """Plain twin of T11 (with T10's twin as the operator): PCG on the
    stacked 3-RHS system from ``x0``, at most ``iterations`` trips, stopping
    before a trip once ``rz ≤ rtol²·rz0`` when ``rtol > 0``
    (``assembly.py:656-725``), and the mask re-select of ``pd.py:195``.
    The preconditioner is Jacobi, or with ``block`` (T22's factor f32[10,
    K]) the disjoint-tet block solve :func:`tet_block_apply_plain`; ``full``
    and ``edges`` go to the operator.  Returns ``(x f32[N, 3], prr f32[P], trips
    i32[1])``: the solution, the block partials of the final ``r·r`` (zero
    when ``failed`` slot 0 is set) and the trips run.  An ensemble (every
    per-node argument with the member axis, ``block`` f32[B, 10, K], ``full``
    and ``edges`` per member) runs member by member, each with its own
    exit: ``(x f32[B, N, 3], prr f32[B, P], trips i32[B, 1])``.

    ``matvec(v, part)`` (a single scene only) replaces T10's twin as the
    operator: it returns ``(A·v f32[N, 3], the block partials of v·A·v or
    None)`` (``part`` True: the partials; a tensor: the partials written
    into it, on the card); the domain decomposition's halo-exchanged
    operator is one (``parallel/domain.py``).  ``ranks`` (the domain over
    several ranks, a ``parallel.ranks.Transport``) makes every dot product
    global: the rank's block partials are gathered from all ranks in rank
    order (``ranks.gather``) before each total, so every rank leaves the
    loop on the same trip (the ``psum``'d dots of ``pies_tpu/parallel/
    domain.py:612-656``); ``prr`` is then every rank's partials, f32[R·P].
    The latch and the totals read here are the same on every rank, so
    every rank issues the same collectives."""
    if members_of(b):
        return each_member(lambda bb, xb, db, mb, wb, kb, fb, ob, cb, eb: pcg_solve_plain(
            bb, xb, db, mb, wb, h2, kb, topo, iterations, rtol, fb, ob, cb, eb),
            members_of(b), b, x0, diag, mass, wf, mask, failed, block, full, edges)
    dev = b.device
    gather = (lambda t: t) if ranks is None else ranks.gather  # noqa: E731
    total = lambda t: finalize(gather(t))  # noqa: E731
    if failed is not None and bool(failed[0]):
        return (x0.clone(), gather(torch.zeros(-(-b.shape[0] // CG_BLOCK), device=dev)),
                torch.zeros(1, dtype=torch.int32, device=dev))
    if matvec is None:
        matvec = lambda v, part=False: apply_system_plain(  # noqa: E731
            v, mass, wf, h2, topo, part=part, full=full, edges=edges)
    y, _ = matvec(x0)
    r = b - y
    if block is None:
        inv = _div(torch.ones_like(diag), diag)[:, None]
        precond = lambda res: inv * res  # noqa: E731
    else:
        precond = lambda res: tet_block_apply_plain(block, res)  # noqa: E731
    z = precond(r)
    p, x = z, x0
    rz = total(block_partials(_dot3(r, z)))
    prr = block_partials(_dot3(r, r))
    tol2 = rz * _rtol2(rtol)
    trips = 0
    live = mask[:, None] > 0
    for _ in range(iterations):
        if rtol > 0.0 and not bool(rz > tol2):
            break
        ap, pap = matvec(p, True)
        x, r, p, rz, prr = cg_trip_plain(x, r, p, ap, rz, total(pap), live, precond, total)
        trips += 1
    return x, gather(prr), torch.full((1,), trips, dtype=torch.int32, device=dev)


def cg_trip_plain(x, r, p, ap, rz, p_ap, live, precond, total):
    """Plain twin of T11's update and direction (one trip after the
    operator): from the totals ``rz`` (r·z before the trip) and ``p_ap``
    (p·Ap), ``(x, r, p, rz_new, prr)`` after it.  ``live`` is the mask
    re-select (bool[N, 1]), ``precond`` the preconditioner, ``total`` turns
    this launch's block partials of r·z into the total (across ranks, with
    every other rank's, in rank order); ``prr`` is this launch's block
    partials of r·r."""
    alpha = torch.where(p_ap > 0, rz / torch.clamp_min(p_ap, 1e-30), 0.0)
    x = torch.where(live, x + alpha * p, x)
    r = r - alpha * ap
    z = precond(r)
    rz_new = total(block_partials(_dot3(r, z)))
    prr = block_partials(_dot3(r, r))
    beta = torch.where(rz > 0, rz_new / torch.clamp_min(rz, 1e-30), 0.0)
    return x, r, z + beta * p, rz_new, prr


def cg_update(x, p, ap, r, z, diag, block, mask, prz, prz0, pap, prr, trips, failed,
              trip: int, early: int, rtol2: float, at: int = 0):
    """T11's update stage of trip ``trip`` on CUDA tensors (one launch, all
    members): x, r and z in place, the r·z partials into row ``(trip + 1)
    & 1`` of ``prz`` f32[..., 2, P] and the r·r partials into ``prr``, this
    launch's blocks at ``at``; its totals (the gate's r·z, p·Ap) sum all P
    partials of ``prz``, ``prz0`` and ``pap``.  Needs ``trips`` ≥ ``trip``
    (the direction stages before it ran), else it returns at once."""
    members = kernels.launch_members(x, failed, p, ap, r, z, diag, mask)
    err = kernels.lib().pies_cg_update(
        x.data_ptr(), p.data_ptr(), ap.data_ptr(), r.data_ptr(), z.data_ptr(),
        diag.data_ptr(), kernels.ptr(block), mask.data_ptr(), prz.data_ptr(), prz0.data_ptr(),
        pap.data_ptr(), prr.data_ptr(), trips.data_ptr(), x.shape[-2], trip, early, rtol2,
        failed.data_ptr(), members, pap.shape[-1], at, kernels.stream())
    kernels.check(err, "cg_update")
    pcg_solve.launches += 1


def cg_direction(p, z, prz, prz0, trips, failed, trip: int, early: int, rtol2: float,
                 at: int = 0):
    """T11's direction stage of trip ``trip`` on CUDA tensors (one launch,
    all members): p = z + beta p in place, beta from the r·z totals of
    both rows of ``prz`` f32[..., 2, P]; block 0 writes ``trips`` = trip +
    1.  ``at`` is where :func:`cg_update` wrote this launch's partials."""
    members = kernels.launch_members(p, failed, z)
    err = kernels.lib().pies_cg_direction(
        p.data_ptr(), z.data_ptr(), prz.data_ptr(), prz0.data_ptr(), trips.data_ptr(),
        p.shape[-2], trip, early, rtol2, failed.data_ptr(), members, prz.shape[-1], at,
        kernels.stream())
    kernels.check(err, "cg_direction")
    pcg_solve.launches += 1


def pcg_solve(b, x0, diag, mass, wf, h2: float, mask, topo: Topology, iterations: int,
              rtol: float = 0.0, failed=None, block=None, full: FullCoupling | None = None,
              edges: EdgeTerms | None = None, matvec=None, ranks=None):
    """T10 + T11 on CUDA tensors, :func:`pcg_solve_plain` on CPU tensors
    (same arguments and results; ``trips`` stays on the device).  Enqueues
    the init and all ``iterations`` trips without waiting: the trips past
    the exit return at once on the device, each member's past its own exit
    in an ensemble (one launch per stage for all members).  ``matvec``
    (see :func:`pcg_solve_plain`) replaces T10: its launches are not gated,
    only T11's stages are.  With ``ranks`` T11 writes this rank's P block
    partials into its slice of buffers of R·P, and each trip runs: the
    matvec (with its exchanges), a gather of p·Ap, the update (which writes
    r·z and r·r), a gather of r·z, the direction; the init's r·z is
    gathered after it and the last r·r after the loop, all in place on the
    stream, so that every rank finalizes the same R·P partials in the same
    order and nothing waits for the host."""
    if kernels.on_cpu(b):
        return pcg_solve_plain(b, x0, diag, mass, wf, h2, mask, topo, iterations, rtol,
                               failed, block, full, edges, matvec, ranks)
    if failed is None:
        raise ValueError("the CG kernels need the failure latch")
    n = b.shape[-2]
    dev = b.device
    lead = b.shape[:-2]
    members = kernels.launch_members(b, failed, x0, diag, mask, mass, wf)
    if block is not None and (n % 4 or tuple(block.shape) != lead + (10, n // 4)):
        raise ValueError("the block preconditioner needs f32[10, N/4] factors per member")
    kernels.require(dev, b, x0, diag, mask, block)
    own = -(-n // CG_BLOCK)  # this launch's blocks
    if ranks is not None and (matvec is None or members_of(b)):
        raise ValueError("the CG across ranks takes a single scene's halo-exchanged operator")
    world, at = (1, 0) if ranks is None else (ranks.world, ranks.rank * own)
    parts = world * own
    # Per-member scratch, once per solve: r.z partials (two rows, a trip
    # reads one and writes the other), r.z at the start, p.Ap and r.r;
    # across ranks every rank's partials, this rank's at [at, at + own).
    prz = torch.empty(lead + (2, parts), dtype=torch.float32, device=dev)
    prz0, pap, prr = (torch.empty(lead + (parts,), dtype=torch.float32, device=dev)
                      for _ in range(3))
    trips = torch.empty(lead + (1,), dtype=torch.int32, device=dev)
    r, z, p, x, ap = (torch.empty_like(b) for _ in range(5))
    lib, stream = kernels.lib(), kernels.stream()
    if matvec is None:
        apply_system(x0, mass, wf, h2, topo, failed, out=ap, full=full, edges=edges)
    else:
        ap = matvec(x0)[0]
    err = lib.pies_cg_init(
        b.data_ptr(), ap.data_ptr(), x0.data_ptr(), diag.data_ptr(), kernels.ptr(block),
        r.data_ptr(),
        z.data_ptr(), p.data_ptr(), x.data_ptr(), prz.data_ptr(), prz0.data_ptr(),
        prr.data_ptr(), trips.data_ptr(), n, failed.data_ptr(), members, parts, at, stream)
    kernels.check(err, "cg_init")
    pcg_solve.launches += 1
    if ranks is not None:
        ranks.gather_(prz[0], own)
        prz0.copy_(prz[0])
    early, rtol2 = int(rtol > 0.0), _rtol2(rtol)
    for i in range(iterations):
        if matvec is None:
            apply_system(p, mass, wf, h2, topo, failed, part=pap, out=ap,
                         gate=(trips, prz, prz0, i, early, rtol2), full=full, edges=edges)
        else:
            ap, _ = matvec(p, pap[at:at + own])
        if ranks is not None:
            ranks.gather_(pap, own)
        cg_update(x, p, ap, r, z, diag, block, mask, prz, prz0, pap, prr, trips, failed, i,
                  early, rtol2, at)
        if ranks is not None:
            ranks.gather_(prz[(i + 1) & 1], own)
        cg_direction(p, z, prz, prz0, trips, failed, i, early, rtol2, at)
    if ranks is not None:
        ranks.gather_(prr, own)
    return x, prr, trips


pcg_solve.launches = 0


# ---------------------------------------------------------------------------
# T22: the disjoint-tet block preconditioner


def tet_block_factor_plain(diag: torch.Tensor, block6: torch.Tensor,
                           failed=None) -> torch.Tensor:
    """Plain twin of T22 (``assembly.py:602-630``): the 4x4 Cholesky of each
    disjoint-tet block of the system, from the full diagonal ``diag`` f32[N]
    and the static off-diagonals ``block6`` f32[6, N/4] — the tet-column
    path's ``block_factor_cols``.  Returns the 10 factor columns f32[10,
    N/4].  ``failed`` is accepted for signature parity.  An ensemble's
    ``diag`` f32[B, N] gives f32[B, 10, N/4], member by member."""
    from .tetcols import _node_cols, block_factor_cols

    if diag.dim() == 2:
        return each_member(lambda d: tet_block_factor_plain(d, block6), diag.shape[0], diag)

    return torch.stack(block_factor_cols(_node_cols(diag, diag.shape[0] // 4), block6))


def tet_block_apply_plain(factors: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``z = (L Lᵀ)⁻¹ r`` per block for the 3 stacked right-hand sides
    (``assembly.py:633-653``, the tet-column path's ``block_solve_cols``);
    ``r`` f32[N, 3], ``factors`` from :func:`tet_block_factor_plain`."""
    from ..constraints.projections import corner_cols
    from .tetcols import _cols_to_node3, block_solve_cols

    return _cols_to_node3(block_solve_cols(tuple(factors), corner_cols(r, factors.shape[1])))


def tet_block_factor(diag: torch.Tensor, block6: torch.Tensor, failed=None) -> torch.Tensor:
    """T22 on CUDA tensors, :func:`tet_block_factor_plain` on CPU tensors.
    On the card ``failed`` is required: the kernel writes nothing when its
    slot 0 is set."""
    if kernels.on_cpu(diag):
        return tet_block_factor_plain(diag, block6, failed)
    if failed is None:
        raise ValueError("the block factor kernel needs the failure latch")
    k = block6.shape[1]
    lead = diag.shape[:-1]
    if diag.shape[-1] != 4 * k or failed.shape[:-1] != lead:
        raise ValueError("the block factor needs the disjoint-tet layout over the capacity"
                         " and the diagonal's member axis on the latch")
    kernels.require(diag.device, diag, block6, failed)
    factors = torch.empty(lead + (10, k), dtype=torch.float32, device=diag.device)
    err = kernels.lib().pies_tet_block_factor(diag.data_ptr(), block6.data_ptr(),
                                              factors.data_ptr(), k, failed.data_ptr(),
                                              lead[0] if lead else 1, kernels.stream())
    kernels.check(err, "tet_block_factor")
    tet_block_factor.launches += 1
    return factors


tet_block_factor.launches = 0
