"""Tet-column PD fast path (port of ``pies_tpu/solver/tetcols.py``).

For disjoint-tet scenes (every node owned by exactly one contiguous tet, the
``Topology.tet_block6`` layout) the PD global system is exactly block
diagonal in 4x4 per-tet blocks, so the iteration loop is a per-tet local step
plus a direct 4x4 block solve.  Corner columns ``x[a][d]`` (corner a of every
tet, axis d) are strided views of the node-major ``[N, 3]`` state here; the
JAX package's layout converters (``node3_to_cols`` and friends) exist only to
dodge TPU tile padding and are not ported.

:func:`substep_cols` is the wrapper of kernel T2 (``kernels/csrc/
tet_cols_substep.cu``); :func:`substep_cols_plain` is its plain twin.

With point-triangle contacts each iteration needs their force at its
iterate: kernel T7 (``kernels/csrc/pt_coupling.cu``) first builds the node
incidence and folds the contacts' diagonal into ``diag`` once per substep
(:func:`pt_coupling_setup`); each T2 iteration then adds ``ptd·x +
contact`` after the floor term, ``contact`` being each contact's push-out
from the current iterate summed per node (:func:`pt_force`; on the main
path computed inside T2, whose :func:`contact_substep` runs all the
iterations in one launch) (``pies_tpu/solver/tetcols.py:194-260,306-349``).

Each wrapper also takes an ensemble's arrays (a leading member axis, see
``state.py``) and launches its kernel once over all members; its plain
twin then runs member by member (``state.each_member``).
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..collision.batches import (
    ATA_DIFF4,
    W_POINT_TRI,
    CollisionSet,
    Incidence,
    csr_sum,
    incidence_plain,
    incident,
)
from ..constraints.projections import corner_cols, tet_force12_fused_cols
from ..ops.math3d import ieee_div as _div
from ..options import StepConfig
from ..state import each_member, members_of
from ..topology import Topology
from . import assembly


def applies(state, topo: Topology, config: StepConfig) -> bool:
    """Static eligibility for the tet-column path, as in the JAX package:
    the block-diagonal layout covering the whole capacity, the fused
    contiguous tet local step, diagonal-only contact coupling, dense floor
    contacts, no node-node and no edge-edge contact buffer (``tetcols.py:
    82-83``: the edge buffer exists where the scene has triangles), and
    (besides position pins) no other constraint family.  The
    host checks it once per scene and
    ``pd.pd_substep`` dispatches on it; a scene where it fails takes the
    generic path."""
    n_pins = topo.position.idx.shape[0]
    return (
        config.tet_cols
        and topo.tet_block6 is not None
        and topo.tet_block6.shape[-1] * 4 == state.capacity
        and config.tet_fused
        and config.strain_contiguous
        and config.volume_contiguous
        and config.contact_coupling in ("diagonal", "recentered")
        and topo.distance.idx.shape[0] == 0
        and (n_pins == 0 or topo.position_force_dense.shape[0] == state.capacity)
        and topo.bend.idx.shape[0] == 0
        and topo.shape.node_idx.shape[0] == 0
        and topo.goal.node_idx.shape[0] == 0
        and not (config.enable_node_collisions and config.budget.max_node_node_contacts > 0)
        and not (config.enable_edge_collisions and topo.triangles.shape[0] > 0
                 and config.budget.max_edge_contacts > 0)
        and config.dense_floor
    )


def block_factor_cols(dcols, block6: torch.Tensor):
    """Batched 4x4 Cholesky from the diagonal's corner columns.  ``1/sqrt`` is
    IEEE ``1.0 / sqrt`` (the kernel does the same)."""
    d0, d1, d2, d3 = dcols
    b01, b02, b03, b12, b13, b23 = (block6[i] for i in range(6))
    i00 = 1.0 / torch.sqrt(d0)
    l10 = b01 * i00
    l20 = b02 * i00
    l30 = b03 * i00
    i11 = 1.0 / torch.sqrt(d1 - l10 * l10)
    l21 = (b12 - l20 * l10) * i11
    l31 = (b13 - l30 * l10) * i11
    i22 = 1.0 / torch.sqrt(d2 - l20 * l20 - l21 * l21)
    l32 = (b23 - l30 * l20 - l31 * l21) * i22
    i33 = 1.0 / torch.sqrt(d3 - l30 * l30 - l31 * l31 - l32 * l32)
    return (l10, l20, l30, l21, l31, l32, i00, i11, i22, i33)


def block_solve_cols(factors, rcols):
    """Solve ``(L Lᵀ) z = r`` per block for 3 stacked right-hand sides."""
    l10, l20, l30, l21, l31, l32, i00, i11, i22, i33 = factors
    out = []
    for d in range(3):
        r0, r1, r2, r3 = (rcols[a][d] for a in range(4))
        y0 = r0 * i00
        y1 = (r1 - l10 * y0) * i11
        y2 = (r2 - l20 * y0 - l21 * y1) * i22
        y3 = (r3 - l30 * y0 - l31 * y1 - l32 * y2) * i33
        z3 = y3 * i33
        z2 = (y2 - l32 * z3) * i22
        z1 = (y1 - l21 * z2 - l31 * z3) * i11
        z0 = (y0 - l10 * z1 - l20 * z2 - l30 * z3) * i00
        out.append((z0, z1, z2, z3))
    return tuple(tuple(out[d][a] for d in range(3)) for a in range(4))


def _block_matvec_cols(dcols, block6, xc):
    """``A·x`` of the block-diagonal system on columns (for the residual)."""
    b01, b02, b03, b12, b13, b23 = (block6[i] for i in range(6))
    off = {(0, 1): b01, (0, 2): b02, (0, 3): b03,
           (1, 2): b12, (1, 3): b13, (2, 3): b23}
    out = []
    for a in range(4):
        row = []
        for d in range(3):
            acc = dcols[a] * xc[a][d]
            for b in range(4):
                if b != a:
                    acc = acc + off[(min(a, b), max(a, b))] * xc[b][d]
            row.append(acc)
        out.append(tuple(row))
    return tuple(out)


def _node_cols(v: torch.Tensor, k: int):
    """Corner columns of a per-node ``f32[N]`` (node 4t+a -> column a)."""
    vt = v.view(k, 4)
    return tuple(vt[:, a] for a in range(4))


def _cols_to_node3(cols) -> torch.Tensor:
    return torch.stack([torch.stack(list(cols[a]), dim=-1) for a in range(4)], dim=1).reshape(-1, 3)


def substep_cols_plain(x, msn_h2, diag, mask, wf, topo: Topology,
                       plane: float, iterations: int, failed=None, pt=None):
    """Plain twin of kernel T2: the PD iteration loop of one substep.

    ``x``/``msn_h2`` f32[N, 3] are the predicted positions and inertia term;
    ``diag``/``mask``/``wf`` f32[N] the system diagonal, node mask and floor
    weight ``W_STATIC·count·active``; every iteration's tet force, the
    first one too, is computed here from its iterate.  ``pt`` (or None) is
    ``(ptd f32[N], contact f32[N, 3], row_start i32[N+1], pt_count
    i32[1])``: when contacts are live, each node with contact entries adds
    ``ptd·x`` and then ``contact`` to its force (elsewhere both are exact
    zeros, and the arrays there are not read).  Returns ``(x_new [N, 3], static_proj
    [N, 3], r2 [K])`` with ``r2`` the per-tet squared residual
    ``‖force − A·x‖²`` (zero where ``failed`` slot 0 is set, as the kernel
    writes it).  An ensemble's arrays (``r2`` f32[B, K]) run member by
    member."""
    if members_of(x):
        return each_member(
            lambda xb, mb, db, kb, wb, lb, pb: substep_cols_plain(
                xb, mb, db, kb, wb, topo, plane, iterations, lb, pb),
            members_of(x), x, msn_h2, diag, mask, wf, failed, pt)
    n = x.shape[0]
    k = n // 4
    c_tet = min(topo.strain.qinv.shape[1], k)
    if topo.position.idx.shape[0]:
        msn_h2 = msn_h2 + topo.position_force_dense
    xc = tuple(tuple(col) for col in corner_cols(x, k))
    msn_c = corner_cols(msn_h2, k)
    mask_c = _node_cols(mask, k)
    diag_c = _node_cols(diag, k)
    wf_c = _node_cols(wf, k)
    factors = block_factor_cols(diag_c, topo.tet_block6)
    if pt is not None:
        ptd, contact, row_start, pt_count = pt
        on = (row_start[1:] > row_start[:-1]) & (pt_count[0] > 0)
        on_c = _node_cols(on, k)
        ptd_c = _node_cols(ptd, k)
        contact_c = corner_cols(contact, k)

    def tet_force(xc_it):
        p = [[xc_it[a][d][:c_tet] for d in range(3)] for a in range(4)]
        f12 = tet_force12_fused_cols(p, topo.strain, topo.volume)
        if c_tet < k:
            pad = torch.zeros(k - c_tet, dtype=x.dtype, device=x.device)
            f12 = [torch.cat([f, pad]) for f in f12]
        return f12

    x_it, x_stale = xc, xc
    force = tuple(tuple(torch.zeros_like(xc[a][d]) for d in range(3)) for a in range(4))
    for it in range(iterations):
        f12 = tet_force(x_it)
        force = []
        for a in range(4):
            sp_y = torch.clamp_min(x_it[a][1], plane)
            row = []
            for d in range(3):
                fad = msn_c[a][d] + f12[3 * a + d]
                fad = fad + wf_c[a] * (sp_y if d == 1 else x_it[a][d])
                if pt is not None:
                    with_pt = (fad + ptd_c[a] * x_it[a][d]) + contact_c[a][d]
                    fad = torch.where(on_c[a], with_pt, fad)
                row.append(fad)
            force.append(tuple(row))
        force = tuple(force)
        zc = block_solve_cols(factors, force)
        x_stale = x_it
        x_it = tuple(
            tuple(torch.where(mask_c[a] > 0, zc[a][d], x_it[a][d]) for d in range(3))
            for a in range(4)
        )

    r2 = torch.zeros(k, dtype=x.dtype, device=x.device)
    if iterations > 0:
        az = _block_matvec_cols(diag_c, topo.tet_block6, x_it)
        for a in range(4):
            for d in range(3):
                r = torch.where(mask_c[a] > 0, force[a][d] - az[a][d], 0.0)
                r2 = r2 + r * r
    if failed is not None:
        r2 = torch.where(failed[0] != 0, 0.0, r2)
    static_c = tuple(
        tuple(
            torch.clamp_min(x_stale[a][1], plane)
            if d == 1 else x_stale[a][d]
            for d in range(3)
        )
        for a in range(4)
    )
    return _cols_to_node3(x_it), _cols_to_node3(static_c), r2


def _t2_inputs(x, topo: Topology):
    """The checks and arrays shared by T2's two entry points: ``(k, c,
    pin, batch)``."""
    n = x.shape[-2]
    k = n // 4
    if n % 4 or topo.tet_block6 is None or topo.tet_block6.shape[1] != k:
        raise ValueError("the tet-column kernel needs the disjoint-tet block layout")
    s, v = topo.strain, topo.volume
    c = s.qinv.shape[1]
    pin = topo.position_force_dense if topo.position.idx.shape[0] else None
    if pin is not None and pin.shape[0] != n:
        raise ValueError("pin force must be dense over the capacity")
    return k, c, pin, (s.qinv, s.g, s.lo, s.hi, s.w, v.lo, v.hi, v.w)


def substep_cols(x, msn_h2, diag, mask, wf, topo: Topology,
                 plane: float, iterations: int, failed=None, pt=None):
    """Kernel T2 on CUDA tensors, :func:`substep_cols_plain` on CPU tensors
    (same arguments and results).  On the card ``failed`` is required: the
    kernel returns at once, writing ``r2 = 0``, when its slot 0 is set.
    The main path's contact substep is :func:`contact_substep`."""
    if kernels.on_cpu(x):
        return substep_cols_plain(x, msn_h2, diag, mask, wf, topo, plane,
                                  iterations, failed, pt)
    if failed is None:
        raise ValueError("the tet-column kernel needs the failure latch")
    k, c, pin, batch = _t2_inputs(x, topo)
    ptd, contact, row_start, pt_count = pt if pt is not None else (None,) * 4
    kernels.require(x.device, x, msn_h2, pin, diag, mask, wf, topo.tet_block6,
                    failed, ptd, contact, row_start, pt_count, *batch)
    x_out = torch.empty_like(x)
    static_out = torch.empty_like(x)
    r2 = torch.empty(x.shape[:-2] + (k,), dtype=torch.float32, device=x.device)
    err = kernels.lib().pies_tet_cols_substep(
        x.data_ptr(), msn_h2.data_ptr(), kernels.ptr(pin), diag.data_ptr(),
        mask.data_ptr(), wf.data_ptr(), topo.tet_block6.data_ptr(),
        *(t.data_ptr() for t in batch),
        x_out.data_ptr(), static_out.data_ptr(), r2.data_ptr(),
        k, c, int(iterations), float(plane), failed.data_ptr(),
        kernels.ptr(ptd), kernels.ptr(contact), kernels.ptr(row_start),
        kernels.ptr(pt_count), max(members_of(x), 1), kernels.stream(),
    )
    kernels.check(err, "tet_cols_substep")
    substep_cols.launches += 1
    return x_out, static_out, r2


substep_cols.launches = 0


def contact_substep_plain(x, msn_h2, diag, mask, wf, topo: Topology, plane: float,
                          iterations: int, failed, ptd, colls: CollisionSet, inc: Incidence,
                          thickness: float):
    """Plain twin of T2's contact substep: ``iterations`` PD iterations
    with point-triangle contacts, one :func:`substep_cols_plain` call an
    iteration, each given T7's force (:func:`pt_force_plain`) at the
    iterate it starts from: the loop ``pd_substep`` runs with
    ``plain=True``.  Returns ``(x_new,
    static_proj, r2)`` of the last iteration (the static projection of the
    iterate it started from)."""
    x_it = x
    out = None
    for it in range(iterations):
        contact = pt_force_plain(x_it, colls, inc, thickness, failed)
        out = substep_cols_plain(x_it, msn_h2, diag, mask, wf, topo, plane, 1, failed,
                                 (ptd, contact, inc.row_start, colls.pt_count))
        x_it = out[0]
    if out is None:
        return substep_cols_plain(x, msn_h2, diag, mask, wf, topo, plane, 0, failed)
    return out


def contact_substep(x, msn_h2, diag, mask, wf, topo: Topology, plane: float,
                    iterations: int, failed, ptd, colls: CollisionSet, inc: Incidence,
                    thickness: float):
    """T2's contact substep (the main path with self-contact) on CUDA
    tensors, :func:`contact_substep_plain` on CPU tensors (same arguments
    and results): ``iterations`` iterations, each with T7's force of the
    contacts ``colls`` over ``inc`` (from :func:`pt_coupling_setup`, with
    its node list) at the iterate it starts from, in one cooperative
    launch: the tets with a node with contact entries iteration by
    iteration, each waiting only for the tets it shares a contact with,
    then every iteration of the others in registers
    (``kernels/csrc/tet_cols_substep.cu``)."""
    if kernels.on_cpu(x):
        return contact_substep_plain(x, msn_h2, diag, mask, wf, topo, plane, iterations,
                                     failed, ptd, colls, inc, thickness)
    if failed is None:
        raise ValueError("the tet-column kernel needs the failure latch")
    if inc.node_list is None or inc.node_count is None:
        raise ValueError("the contact substep needs the incidence's node list from"
                         " pt_coupling_setup")
    if iterations <= 0:  # (no iteration: nothing reads the contacts)
        return substep_cols(x, msn_h2, diag, mask, wf, topo, plane, 0, failed)
    k, c, pin, batch = _t2_inputs(x, topo)
    kernels.require(x.device, x, msn_h2, pin, diag, mask, wf, topo.tet_block6, failed,
                    ptd, inc.row_start, colls.pt_count, inc.entries, colls.pt_idx,
                    colls.pt_mask, inc.node_list, inc.node_count, *batch)
    members = kernels.launch_members(x, failed, ptd, colls.pt_count, colls.pt_idx,
                                     inc.node_list, inc.node_count)
    x_out = torch.empty_like(x)
    static_out = torch.empty_like(x)
    lead = x.shape[:-2]
    r2 = torch.empty(lead + (k,), dtype=torch.float32, device=x.device)
    # (scratch: the other iterate buffer; a member's work counters, epoch and
    # a progress flag a tet, which the kernel keeps ready for the next call)
    buf = kernels.scratch("T2 iterate", tuple(x.shape), torch.float32, x.device)
    sync = kernels.scratch("T2 sync", lead + (4 + k,), torch.int32, x.device, zeroed=True)
    err = kernels.lib().pies_tet_cols_contact(
        x.data_ptr(), msn_h2.data_ptr(), kernels.ptr(pin), diag.data_ptr(),
        mask.data_ptr(), wf.data_ptr(), topo.tet_block6.data_ptr(),
        *(t.data_ptr() for t in batch),
        x_out.data_ptr(), static_out.data_ptr(), r2.data_ptr(), buf.data_ptr(),
        sync.data_ptr(), k, c, int(iterations), float(plane),
        failed.data_ptr(), ptd.data_ptr(), inc.row_start.data_ptr(),
        colls.pt_count.data_ptr(), inc.entries.data_ptr(), colls.pt_idx.data_ptr(),
        colls.pt_mask.data_ptr(), inc.node_list.data_ptr(), inc.node_count.data_ptr(),
        inc.cap, float(thickness), members, kernels.stream(),
    )
    kernels.check(err, "tet_cols_contact")
    contact_substep.launches += 1
    return x_out, static_out, r2


contact_substep.launches = 0


def contact_occupancy() -> int:
    """Blocks of T2's cooperative contact launch that one SM of the current
    card keeps resident (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return kernels.lib().pies_tet_cols_contact_occupancy()


# ---------------------------------------------------------------------------
# kernel T7: point-triangle coupling


_COL0 = [float(ATA_DIFF4[a, 0]) for a in range(4)]


@functools.lru_cache(maxsize=64)
def coupling_grid(device: torch.device, members: int, n: int) -> int:
    """Blocks per member of T7's cooperative setup grid on ``device`` (its
    scratch is sized by it; members past what one launch keeps resident go
    to further launches)."""
    grid = kernels.lib().pies_pt_coupling_grid(members, n)
    if grid <= 0:
        raise RuntimeError("the coupling setup: no block of the cooperative kernel stays resident")
    return grid


def pt_coupling_setup_plain(colls: CollisionSet, mass: torch.Tensor, topo: Topology,
                            h2: float, diag: torch.Tensor, wf: torch.Tensor,
                            failed: torch.Tensor | None = None,
                            static_diag: torch.Tensor | None = None):
    """Plain twin of T7's once-per-substep stages: the node incidence of the
    live contacts, the contacts' diagonal ``ptd`` and, at every node with
    contact entries, ``diag = ((m/h² + stiffness) + ptd) + floor`` in place
    (``assembly.py:577-599``).  ``static_diag`` f32[N] (the generic path's
    dense operator diagonal, preset to the floor weight ``wf``) becomes
    ``wf + ptd`` at those nodes (``pd.py:81-99``).  Returns ``(incidence, ptd
    f32[N])``.  An ensemble (``mass`` f32[B, N], ``static_diag`` f32[B, N]
    on the generic path) runs member by member; its incidence has a leading
    member axis."""
    if mass.dim() == 2:
        return each_member(lambda c, m, d, w, f, sd: pt_coupling_setup_plain(c, m, topo, h2, d,
                                                                             w, f, sd),
                           mass.shape[0], colls, mass, diag, wf, failed, static_diag)
    n = mass.shape[0]
    inc = incidence_plain(colls.pt_idx, colls.pt_count, n)
    ptd = assembly.point_tri_collision_diag(colls.pt_idx, colls.pt_mask, n, inc)
    if failed is None or not bool(failed[0]):
        full = ((_div(mass, h2) + topo.stiffness_diag) + ptd) + wf
        diag.copy_(torch.where(incident(inc), full, diag))
        if static_diag is not None:
            static_diag.copy_(torch.where(incident(inc), wf + ptd, static_diag))
    return inc, ptd


def pt_coupling_setup(colls: CollisionSet, mass: torch.Tensor, topo: Topology, h2: float,
                      diag: torch.Tensor, wf: torch.Tensor,
                      failed: torch.Tensor | None = None,
                      static_diag: torch.Tensor | None = None):
    """T7's once-per-substep stages on CUDA tensors (the plain twin on CPU
    tensors).  On the card ``ptd`` is written only at nodes with contact
    entries, and nothing at all when ``failed`` slot 0 is set; the
    incidence also lists the incident nodes (``node_list``,
    ``node_count``) for :func:`pt_force`."""
    if kernels.on_cpu(mass):
        return pt_coupling_setup_plain(colls, mass, topo, h2, diag, wf, failed, static_diag)
    if failed is None:
        raise ValueError("the coupling kernel needs the failure latch")
    dev = mass.device
    n, cap = mass.shape[-1], colls.pt_idx.shape[-2]
    lead = mass.shape[:-1]  # (B,) for an ensemble
    kernels.require(dev, colls.pt_idx, colls.pt_mask, colls.pt_count, mass,
                    topo.stiffness_diag, diag, wf, failed, static_diag)
    b = lead[0] if lead else 1
    if b * max(n + 1, 4 * cap) >= 1 << 31:
        raise ValueError("the coupling kernel takes fewer than 2^31 nodes and entries in all")
    grid = coupling_grid(dev, b, n)
    # (scratch: the degrees, all 0 between calls, and the block sums)
    deg = kernels.scratch("T7 degrees", lead + (n,), torch.int32, dev, zeroed=True)
    sums = kernels.scratch("T7 sums", lead + (grid,), torch.int64, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    row_start = torch.empty(lead + (n + 1,), **i32)
    entries = torch.empty(lead + (4 * cap,), **i32)
    nodes = torch.empty(lead + (4 * cap,), **i32)
    node_list = torch.empty(lead + (4 * cap,), **i32)
    node_count = torch.empty(lead + (1,), **i32)
    ptd = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    err = kernels.lib().pies_pt_coupling_setup(
        colls.pt_idx.data_ptr(), colls.pt_mask.data_ptr(), colls.pt_count.data_ptr(),
        mass.data_ptr(), topo.stiffness_diag.data_ptr(), wf.data_ptr(), diag.data_ptr(),
        deg.data_ptr(), row_start.data_ptr(), entries.data_ptr(), nodes.data_ptr(),
        node_list.data_ptr(), node_count.data_ptr(), sums.data_ptr(), ptd.data_ptr(),
        kernels.ptr(static_diag), failed.data_ptr(), n, cap, h2, b, grid, kernels.stream(),
    )
    kernels.check(err, "pt_coupling_setup")
    pt_coupling_setup.launches += 1
    return Incidence(row_start, entries, nodes, cap, node_list, node_count), ptd


pt_coupling_setup.launches = 0


def pt_force_plain(x: torch.Tensor, colls: CollisionSet, inc: Incidence, thickness: float,
                   failed: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of T7's per-iteration stage (``pt_force_cols``,
    ``tetcols.py:194-260``): each contact's point push-out ``delta`` along
    the unit normal of its triangle at the iterate ``x``, and per node the
    sum of ``(w·mask·AᵀA[a, 0])·delta`` over its entries.  Returns f32[N, 3],
    zero at nodes without entries.  An ensemble runs member by member."""
    if members_of(x):
        return each_member(lambda xb, cb, ib, fb: pt_force_plain(xb, cb, ib, thickness, fb),
                           members_of(x), x, colls, inc, failed)
    a, b, c, d = (x[colls.pt_idx[:, j].long()] for j in range(4))
    e1, e2 = c - b, d - b
    nx = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
    ny = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
    nz = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    nn = torch.sqrt(nx * nx + ny * ny + nz * nz)
    inv = _div(torch.ones_like(nn), torch.clamp_min(nn, 1e-20))
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    ndp = nx * (a[:, 0] - b[:, 0]) + ny * (a[:, 1] - b[:, 1]) + nz * (a[:, 2] - b[:, 2])
    disp = torch.where(ndp < thickness, thickness - ndp, 0.0)
    delta = torch.stack([disp * nx, disp * ny, disp * nz], dim=1)
    w = W_POINT_TRI * colls.pt_mask
    vals = torch.cat([(w * _COL0[j])[:, None] * delta for j in range(4)])
    return csr_sum(inc, vals)


def pt_force(x: torch.Tensor, colls: CollisionSet, inc: Incidence, thickness: float,
             failed: torch.Tensor | None = None) -> torch.Tensor:
    """T7's per-iteration stage on a CUDA tensor, :func:`pt_force_plain` on
    a CPU tensor.  On the card the result is written only at nodes with
    contact entries (T2 reads nothing else)."""
    if kernels.on_cpu(x):
        return pt_force_plain(x, colls, inc, thickness, failed)
    if failed is None:
        raise ValueError("the coupling kernel needs the failure latch")
    if inc.node_list is None or inc.node_count is None:
        raise ValueError("the coupling kernel needs the incidence's node list from"
                         " pt_coupling_setup")
    kernels.require(x.device, x, colls.pt_idx, colls.pt_mask, colls.pt_count,
                    inc.row_start, inc.entries, inc.node_list, inc.node_count, failed)
    contact = torch.empty_like(x)
    err = kernels.lib().pies_pt_force(
        x.data_ptr(), colls.pt_idx.data_ptr(), colls.pt_mask.data_ptr(),
        colls.pt_count.data_ptr(), inc.row_start.data_ptr(), inc.entries.data_ptr(),
        inc.node_list.data_ptr(), inc.node_count.data_ptr(), contact.data_ptr(),
        failed.data_ptr(), x.shape[-2], inc.cap, thickness, max(members_of(x), 1),
        kernels.stream(),
    )
    kernels.check(err, "pt_force")
    pt_force.launches += 1
    return contact


pt_force.launches = 0
