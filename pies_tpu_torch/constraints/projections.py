"""The PD local step, family by family (port of
``pies_tpu/constraints/projections.py:48-77,194-504``).

:func:`tet_force12` is the wrapper of kernel T1 (``kernels/csrc/
tet_force.cu``), the element-major form of the tet-column path;
:func:`tet_force12_gathered` is stage 1 of kernel T9 (``kernels/csrc/
tet_force_nodes.cu``), the shared-node form that gathers its corners through
the tet ids: strain and volume fused, or one of them alone.

The other families each fill their part of the generic path's force-row
buffer (``topology.row_layout``) with ``w·AᵀB·p``, the rows that the JAX
package's ``assemble_force`` scatters: :func:`distance_rows` and
:func:`bend_rows` (kernel T12, ``kernels/csrc/constraint_rows.cu``),
:func:`shape_rows` and :func:`goal_rows` (kernel T13, ``kernels/csrc/
shape_match.cu``).  The projections themselves (:func:`project_distance_delta`,
:func:`project_bend`, :func:`project_shape`, :func:`project_goal`) are plain
PyTorch, as the JAX package's are plain JAX.

The PBD solver's forms (:func:`project_distance`, :func:`project_position`,
:func:`project_strain` and the shared :func:`project_bend`) feed
:func:`jacobi_rows`, stage 1 of kernel T18 (``kernels/csrc/
pbd_constraints.cu``): each Jacobi family's ``w·(projected − x)`` rows.

Every wrapper has a plain twin (``*_plain``), used for CPU tensors and as
the oracle on the card.  The twins do each float32 operation in the kernels'
order, so the two agree bit for bit wherever no ``acos``, ``sin`` or ``cos``
is involved.

An ensemble (``state.py``: positions f32[B, N, 3]) goes through the same
wrappers: a CUDA tensor with a member axis launches each kernel once with
the member count, the rows go to f32[B, R, 3] (a member-major view of the
row buffer) and the shape groups' rotations are per member, f32[B, G, 4];
each twin runs member by member (``state.each_member``).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..ops import math3d
from ..ops.math3d import ieee_div as _div
from ..state import each_member, members_of
from ..topology import BendBatch, DistanceBatch, GroupBatch, PositionBatch, TetBatch

SHAPE_BLOCK = 128  # threads per group in kernels/csrc/shape_match.cu
TET_KINDS = {"fused": 0, "strain": 1, "volume": 2}


def _compute_d_flat(sigma, lo, hi):
    """Additive singular-value correction driving ``∏(σ+D)`` into
    ``[lo, hi]`` by 10 fixed steps (``computeD``, ``Constraints.cpp:186-203``)."""
    d = tuple(torch.zeros_like(s) for s in sigma)
    for _ in range(10):
        spd = tuple(s + dd for s, dd in zip(sigma, d))
        product = spd[0] * spd[1] * spd[2]
        omega = torch.clamp(product, lo, hi)
        c = product - omega
        grad = (spd[1] * spd[2], spd[0] * spd[2], spd[0] * spd[1])
        gg = grad[0] * grad[0] + grad[1] * grad[1] + grad[2] * grad[2]
        gd = grad[0] * d[0] + grad[1] * d[1] + grad[2] * d[2]
        scale = (gd - c) / torch.clamp_min(gg, 1e-20)
        d = tuple(scale * g for g in grad)
    return d


def tet_force12_fused_cols(p, strain: TetBatch, volume: TetBatch):
    """Corner positions ``p[a][d]`` (4 x 3 tensors ``f32[C]``) -> the combined
    strain + volume force ``w_s·AᵀB·p̂_s + w_v·AᵀB·p̂_v`` as 12 ``f32[C]``
    columns, index ``3a + d``.  Both constraints share the tets, so one SVD
    serves both and the weighted singular values are combined before one
    reconstruction."""
    e = [[p[k + 1][d] - p[0][d] for d in range(3)] for k in range(3)]
    qf = tuple(strain.qinv[r] for r in range(9))
    f = tuple(
        e[0][d] * qf[0 + j] + e[1][d] * qf[3 + j] + e[2][d] * qf[6 + j]
        for d in range(3)
        for j in range(3)
    )
    u, sigma, v = math3d.svd3x3_flat(f)

    s_strain = [torch.clamp(s, strain.lo, strain.hi) for s in sigma]
    inverted = math3d.det3x3_flat(f) < 0.0
    s_strain[2] = s_strain[2] * torch.where(inverted, -1.0, 1.0)
    dcorr = _compute_d_flat(sigma, volume.lo, volume.hi)
    s_volume = [s + dd for s, dd in zip(sigma, dcorr)]
    s_comb = [strain.w * ss + volume.w * sv for ss, sv in zip(s_strain, s_volume)]
    fhat = tuple(
        u[3 * d + 0] * s_comb[0] * v[3 * j + 0]
        + u[3 * d + 1] * s_comb[1] * v[3 * j + 1]
        + u[3 * d + 2] * s_comb[2] * v[3 * j + 2]
        for d in range(3)
        for j in range(3)
    )
    g = strain.g  # [12, C], row 4j+a
    out = []
    for a in range(4):
        ga = [g[4 * j + a] for j in range(3)]
        for d in range(3):
            out.append(
                ga[0] * fhat[3 * d + 0] + ga[1] * fhat[3 * d + 1] + ga[2] * fhat[3 * d + 2]
            )
    return out


def corner_cols(x: torch.Tensor, c: int):
    """``p[a][d]``: the corner columns of tets 0..c-1 of the element-major
    node array ``x`` (tet t owns nodes 4t..4t+3).  Strided views, no copy."""
    xt = x[: 4 * c].view(c, 4, 3)
    return [[xt[:, a, d] for d in range(3)] for a in range(4)]


def tet_force12_plain(x: torch.Tensor, strain: TetBatch, volume: TetBatch,
                      failed: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of kernel T1: ``f32[12, C]`` forces of every tet of the
    batch, from the element-major positions ``x`` f32[N, 3].  ``failed`` is
    accepted for signature parity; a skipped tick ignores the result.  An
    ensemble's ``x`` f32[B, N, 3] gives f32[B, 12, C], member by member."""
    if members_of(x):
        return each_member(lambda xb, fb: tet_force12_plain(xb, strain, volume, fb),
                           members_of(x), x, failed)
    c = strain.qinv.shape[1]
    return torch.stack(tet_force12_fused_cols(corner_cols(x, c), strain, volume))


def tet_force12(x: torch.Tensor, strain: TetBatch, volume: TetBatch,
                failed: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel T1 on a CUDA tensor, its plain twin on a CPU tensor.

    ``failed`` (the state's ``i32[2]`` latch, ``i32[B, 2]`` for an
    ensemble) makes the kernel return at once when slot 0 is set."""
    if kernels.on_cpu(x):
        return tet_force12_plain(x, strain, volume, failed)
    c = strain.qinv.shape[1]
    n = x.shape[-2]
    if n < 4 * c:
        raise ValueError(f"{c} tets need {4 * c} nodes, got {n}")
    b = (strain.qinv, strain.g, strain.lo, strain.hi, strain.w,
         volume.lo, volume.hi, volume.w)
    kernels.require(x.device, x, failed, *b)
    out = torch.empty(x.shape[:-2] + (12, c), dtype=torch.float32, device=x.device)
    err = kernels.lib().pies_tet_force12(
        x.data_ptr(), *(t.data_ptr() for t in b), out.data_ptr(), c, n,
        kernels.ptr(failed), max(members_of(x), 1), kernels.stream(),
    )
    kernels.check(err, "tet_force12")
    tet_force12.launches += 1
    return out


tet_force12.launches = 0


def tet_force12_single_cols(p, batch: TetBatch, kind: str):
    """Corner positions ``p[a][d]`` -> one family's force ``w·AᵀB·p̂`` as 12
    ``f32[C]`` columns, index ``3a + d`` (``tet_force12``,
    ``projections.py:210-277``): ``kind`` "strain" clamps the singular
    values (the third negated on an inverted tet), "volume" corrects them;
    the weight multiplies last."""
    e = [[p[k + 1][d] - p[0][d] for d in range(3)] for k in range(3)]
    qf = tuple(batch.qinv[r] for r in range(9))
    f = tuple(
        e[0][d] * qf[0 + j] + e[1][d] * qf[3 + j] + e[2][d] * qf[6 + j]
        for d in range(3)
        for j in range(3)
    )
    u, sigma, v = math3d.svd3x3_flat(f)
    if kind == "strain":
        s_hat = [torch.clamp(s, batch.lo, batch.hi) for s in sigma]
        inverted = math3d.det3x3_flat(f) < 0.0
        s_hat[2] = s_hat[2] * torch.where(inverted, -1.0, 1.0)
    else:
        dcorr = _compute_d_flat(sigma, batch.lo, batch.hi)
        s_hat = [s + dd for s, dd in zip(sigma, dcorr)]
    fhat = tuple(
        u[3 * d + 0] * s_hat[0] * v[3 * j + 0]
        + u[3 * d + 1] * s_hat[1] * v[3 * j + 1]
        + u[3 * d + 2] * s_hat[2] * v[3 * j + 2]
        for d in range(3)
        for j in range(3)
    )
    g = batch.g
    out = []
    for a in range(4):
        ga = [g[4 * j + a] for j in range(3)]
        for d in range(3):
            out.append(batch.w * (
                ga[0] * fhat[3 * d + 0] + ga[1] * fhat[3 * d + 1] + ga[2] * fhat[3 * d + 2]
            ))
    return out


def _rows_out(out: torch.Tensor | None, rows: int, like: torch.Tensor,
              members: int = 0) -> torch.Tensor:
    """``out`` checked, or a new f32[rows, 3] (f32[members, rows, 3] for an
    ensemble) beside ``like``."""
    shape = ((members,) if members else ()) + (rows, 3)
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=like.device)
    if tuple(out.shape) != shape:
        raise ValueError(f"the rows go to f32{list(shape)}, got {tuple(out.shape)}")
    return out


def _twin_rows(fn, x: torch.Tensor, out, *args):
    """A row twin on an ensemble: ``fn(x_b, *args_b, out_b)`` member by
    member; returns ``out`` when given, else the stacked rows."""
    rows = each_member(fn, members_of(x), x, *args, out)
    return rows if out is None else out


def _store(out: torch.Tensor | None, rows: torch.Tensor) -> torch.Tensor:
    if out is None:
        return rows
    _rows_out(out, rows.shape[0], rows).copy_(rows)
    return out


def tet_force12_gathered_plain(x: torch.Tensor, strain: TetBatch, volume: TetBatch,
                               failed: torch.Tensor | None = None, out=None,
                               kind: str = "fused") -> torch.Tensor:
    """Plain twin of T9's stage 1 (``tet_force12_fused`` or ``tet_force12``
    with the gather, ``projections.py:210-308``): the force of every tet of
    the batch, corners gathered from ``x`` f32[N, 3] through the batch's
    ids, as the JAX scatter's update rows ``blocks`` f32[4C, 3] (row
    ``a·C + t`` is corner a of tet t), written to ``out`` when given.
    ``kind``: "fused" (strain + volume on shared tets), "strain" or "volume"
    (that batch alone).  ``failed`` is accepted for signature parity.  An
    ensemble's ``x`` f32[B, N, 3] gives f32[B, 4C, 3], member by member."""
    if members_of(x):
        return _twin_rows(lambda xb, fb, ob: tet_force12_gathered_plain(xb, strain, volume, fb,
                                                                       ob, kind), x, out, failed)
    batch = volume if kind == "volume" else strain
    idx = batch.idx.long()
    p = [[x[idx[:, a], d] for d in range(3)] for a in range(4)]
    f12 = (tet_force12_fused_cols(p, strain, volume) if kind == "fused"
           else tet_force12_single_cols(p, batch, kind))
    return _store(out, torch.cat([torch.stack(f12[3 * a:3 * a + 3], dim=1) for a in range(4)]))


def tet_force12_gathered(x: torch.Tensor, strain: TetBatch, volume: TetBatch,
                         failed: torch.Tensor | None = None, out=None,
                         kind: str = "fused") -> torch.Tensor:
    """T9's stage 1 on a CUDA tensor, its plain twin on a CPU tensor.  On the
    card ``failed`` is required: the kernel returns at once when its slot 0
    is set."""
    if kernels.on_cpu(x):
        return tet_force12_gathered_plain(x, strain, volume, failed, out, kind)
    if failed is None:
        raise ValueError("the gathered tet-force kernel needs the failure latch")
    first, second = {"fused": (strain, volume), "strain": (strain, strain),
                     "volume": (volume, volume)}[kind]
    c = first.qinv.shape[1]
    if tuple(first.idx.shape) != (c, 4):
        raise ValueError(f"tet ids must be [{c}, 4], got {tuple(first.idx.shape)}")
    b = (first.qinv, first.g, first.lo, first.hi, first.w,
         second.lo, second.hi, second.w)
    blocks = _rows_out(out, 4 * c, x, members_of(x))
    stride = kernels.row_stride(x.device, blocks)
    kernels.require(x.device, x, first.idx, failed, *b)
    err = kernels.lib().pies_tet_force12_gather(
        x.data_ptr(), first.idx.data_ptr(), *(t.data_ptr() for t in b),
        blocks.data_ptr(), c, TET_KINDS[kind], failed.data_ptr(), x.shape[-2], stride,
        kernels.launch_members(x, failed), kernels.stream(),
    )
    kernels.check(err, "tet_force12_gather")
    tet_force12_gathered.launches += 1
    return blocks


tet_force12_gathered.launches = 0


# ---------------------------------------------------------------------------
# T12: distance and bend rows


def project_distance_delta(x: torch.Tensor, batch: DistanceBatch) -> torch.Tensor:
    """``p0 − p1`` f32[C, 3] of the distance projection
    (``projections.py:48-77``, ``Constraints.cpp:11-37``): only node 0
    moves, by the full ``−(rest − dist)·dir``, and the direction falls back
    to ``(1, 0, 0)`` when ``dist ≤ 1e-5``."""
    idx = batch.idx.long()
    ga, gb = x[idx[:, 0]], x[idx[:, 1]]
    df = [gb[:, d] - ga[:, d] for d in range(3)]
    dist = torch.sqrt(df[0] * df[0] + df[1] * df[1] + df[2] * df[2])
    safe = dist > 1e-5
    inv = _div(torch.ones_like(dist), torch.clamp_min(dist, 1e-20))
    dirs = [torch.where(safe, df[d] * inv, 1.0 if d == 0 else 0.0) for d in range(3)]
    disp = batch.rest - dist
    return torch.stack([-(df[d] + disp * dirs[d]) for d in range(3)], dim=-1)


def distance_rows_plain(x: torch.Tensor, batch: DistanceBatch, failed=None,
                        out=None) -> torch.Tensor:
    """Plain twin of T12's distance kernel: the update rows f32[2C, 3] of
    ``assemble_force``'s distance scatter (``assembly.py:218-227``),
    ``+0.5·w·(p0 − p1)`` for the C first nodes, then the negated rows for
    the second nodes; f32[B, 2C, 3] for an ensemble, member by member."""
    if members_of(x):
        return _twin_rows(lambda xb, fb, ob: distance_rows_plain(xb, batch, fb, ob), x, out,
                          failed)
    half = (0.5 * batch.w)[:, None] * project_distance_delta(x, batch)
    return _store(out, torch.cat([half, -half]))


def distance_rows(x: torch.Tensor, batch: DistanceBatch, failed=None, out=None) -> torch.Tensor:
    """T12's distance kernel on a CUDA tensor, its twin on a CPU tensor."""
    if kernels.on_cpu(x):
        return distance_rows_plain(x, batch, failed, out)
    if failed is None:
        raise ValueError("the distance-row kernel needs the failure latch")
    c = batch.idx.shape[0]
    rows = _rows_out(out, 2 * c, x, members_of(x))
    stride = kernels.row_stride(x.device, rows)
    kernels.require(x.device, x, batch.idx, batch.rest, batch.w, failed)
    err = kernels.lib().pies_distance_rows(
        x.data_ptr(), batch.idx.data_ptr(), batch.rest.data_ptr(), batch.w.data_ptr(),
        rows.data_ptr(), c, failed.data_ptr(), x.shape[-2], stride,
        kernels.launch_members(x, failed), kernels.stream())
    kernels.check(err, "distance_rows")
    distance_rows.launches += 1
    return rows


distance_rows.launches = 0


def _cross(u, v):
    return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                        u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                        u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)


def _norm3(u):
    return torch.sqrt(u[:, 0] * u[:, 0] + u[:, 1] * u[:, 1] + u[:, 2] * u[:, 2])


def project_bend(x: torch.Tensor, inv_mass: torch.Tensor, batch: BendBatch) -> torch.Tensor:
    """Dihedral-angle projection f32[C, 4, 3] per the PBD 2007 paper,
    Appendix A (``projections.py:359-406``, ``Constraints.cpp:312-366``).
    Degenerate triangles (``Σ|q|² < 1e-5``) leave the positions as they
    are; the normal divisions are guarded with a tiny epsilon."""
    idx = batch.idx.long()
    p = [x[idx[:, k]] for k in range(4)]
    wim = [inv_mass[idx[:, k]] for k in range(4)]
    p2, p3, p4 = p[1] - p[0], p[2] - p[0], p[3] - p[0]
    c23, c24 = _cross(p2, p3), _cross(p2, p4)
    l23 = torch.clamp_min(_norm3(c23), 1e-20)[:, None]
    l24 = torch.clamp_min(_norm3(c24), 1e-20)[:, None]
    n1, n2 = c23 / l23, c24 / l24
    d = torch.clamp(n1[:, 0] * n2[:, 0] + n1[:, 1] * n2[:, 1] + n1[:, 2] * n2[:, 2],
                    -1.0, 1.0)
    c = torch.acos(d) - batch.rest_angle
    dd = d[:, None]
    q3 = (_cross(p2, n2) + _cross(n1, p2) * dd) / l23
    q4 = (_cross(p2, n1) + _cross(n2, p2) * dd) / l24
    q2 = (-(_cross(p3, n2) + _cross(n1, p3) * dd)) / l23 \
        - (_cross(p4, n1) + _cross(n2, p4) * dd) / l24
    q1 = -q2 - q3 - q4
    q = [q1, q2, q3, q4]
    w_sum = torch.clamp_min(wim[0] + wim[1] + wim[2] + wim[3], 1e-20)
    q_sq = None
    for qk in q:
        for dim in range(3):
            sq = qk[:, dim] * qk[:, dim]
            q_sq = sq if q_sq is None else q_sq + sq
    num = torch.sqrt(torch.clamp_min(1.0 - d * d, 0.0)) * c
    scale = torch.where(q_sq < 1e-5, 0.0, num / torch.clamp_min(q_sq, 1e-20))
    out = [p[k] + ((-q[k]) * (4.0 * wim[k] / w_sum)[:, None]) * scale[:, None]
           for k in range(4)]
    return torch.stack(out, dim=1)


def bend_rows_plain(x: torch.Tensor, inv_mass: torch.Tensor, batch: BendBatch,
                    failed=None, out=None) -> torch.Tensor:
    """Plain twin of T12's bend kernel: the update rows f32[4C, 3] of
    ``assemble_force``'s bend scatter (``assembly.py:269-271``), row
    ``4c + k`` the weighted projection ``w·p`` of node k of bend c;
    f32[B, 4C, 3] for an ensemble, member by member."""
    if members_of(x):
        return _twin_rows(lambda xb, mb, fb, ob: bend_rows_plain(xb, mb, batch, fb, ob), x, out,
                          inv_mass, failed)
    rows = batch.w[:, None, None] * project_bend(x, inv_mass, batch)
    return _store(out, rows.reshape(-1, 3))


def bend_rows(x: torch.Tensor, inv_mass: torch.Tensor, batch: BendBatch, failed=None,
              out=None) -> torch.Tensor:
    """T12's bend kernel on a CUDA tensor, its twin on a CPU tensor.  The
    two agree to the roundoff of ``acos`` (``acosf`` in the kernel)."""
    if kernels.on_cpu(x):
        return bend_rows_plain(x, inv_mass, batch, failed, out)
    if failed is None:
        raise ValueError("the bend-row kernel needs the failure latch")
    c = batch.idx.shape[0]
    rows = _rows_out(out, 4 * c, x, members_of(x))
    stride = kernels.row_stride(x.device, rows)
    kernels.require(x.device, x, inv_mass, batch.idx, batch.rest_angle, batch.w, failed)
    err = kernels.lib().pies_bend_rows(
        x.data_ptr(), inv_mass.data_ptr(), batch.idx.data_ptr(),
        batch.rest_angle.data_ptr(), batch.w.data_ptr(), rows.data_ptr(), c,
        failed.data_ptr(), x.shape[-2], stride, kernels.launch_members(x, failed, inv_mass),
        kernels.stream())
    kernels.check(err, "bend_rows")
    bend_rows.launches += 1
    return rows


bend_rows.launches = 0


# ---------------------------------------------------------------------------
# T13: shape- and goal-matching rows


def _lane_tree(w: torch.Tensor) -> torch.Tensor:
    """The ``SHAPE_BLOCK``-wide pairwise tree over axis 1: v[t] += v[t + s]."""
    s = SHAPE_BLOCK // 2
    while s:
        w = w[:, :s] + w[:, s:2 * s]
        s //= 2
    return w[:, 0]


def shape_group_sums(x: torch.Tensor, mass: torch.Tensor, batch: GroupBatch) -> torch.Tensor:
    """Per group, the 15 sums f32[G, 15] over its members of ``(x | m·xᵢ·matⱼ
    | m·mat)`` (``shape_group_moments``, ``projections.py:409-443``), summed
    in kernel T13's fixed order: lane t of ``SHAPE_BLOCK`` adds the group's
    members t, t + 128, ... one after another, then the lanes are summed by
    the pairwise tree."""
    g = batch.num_groups
    k = max(1, -(-batch.max_count // SHAPE_BLOCK))
    start = batch.member_start.long()
    at = start[:-1, None] + torch.arange(k * SHAPE_BLOCK, device=x.device)[None, :]
    valid = at < start[1:, None]
    at = torch.where(valid, at, 0)
    node = batch.node_idx.long()[at]
    mask = batch.member_mask[at]
    mat = batch.mat_coords[at]  # [G, KB, 3]
    xg = x[node] * mask[..., None]
    m = mass[node] * mask
    mx = m[..., None] * xg
    cols = torch.cat(
        [xg] + [mx[..., i:i + 1] * mat[..., j:j + 1] for i in range(3) for j in range(3)]
        + [m[..., None] * mat], dim=-1)
    cols = torch.where(valid[..., None], cols, 0.0).view(g, k, SHAPE_BLOCK, 15)
    acc = cols[:, 0]
    for j in range(1, k):
        acc = acc + cols[:, j]
    return _lane_tree(acc)


def shape_group_moments(x: torch.Tensor, mass: torch.Tensor, batch: GroupBatch):
    """Per-group COM f32[G, 3] (equal weights ``1/count``: the reference's
    COM is not mass-weighted) and mass-weighted moment matrix f32[G, 3, 3],
    expanded around the origin: ``Σ m·x·matᵀ − com·(Σ m·mat)ᵀ``."""
    s = shape_group_sums(x, mass, batch)
    com = s[:, :3] * batch.inv_count[:, None]
    p = s[:, 3:12].reshape(-1, 3, 3) - com[:, :, None] * s[:, 12:15][:, None, :]
    return com, p


def _member_weights(batch: GroupBatch) -> torch.Tensor:
    return batch.w[batch.group_idx.long()] * batch.member_mask


def project_shape(x: torch.Tensor, mass: torch.Tensor, quats: torch.Tensor,
                  batch: GroupBatch, rotation_iterations: int):
    """Shape-matching projection (``projections.py:446-485``,
    ``ShapeMatchingConstraint.cpp:96-122``): ``(projected member positions
    f32[M, 3], updated quats f32[G, 4])``.  ``F = P·Qinv``; padded groups
    get ``F = I`` and keep their quaternion."""
    com, p = shape_group_moments(x, mass, batch)
    qi = batch.qinv
    f = torch.stack(
        [p[:, i, 0] * qi[:, 0, k] + p[:, i, 1] * qi[:, 1, k] + p[:, i, 2] * qi[:, 2, k]
         for i in range(3) for k in range(3)], dim=-1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand_as(f)
    f = torch.where(batch.group_mask[:, None, None] > 0, f, eye)
    quats = math3d.extract_rotation(f, quats, rotation_iterations)
    gi = batch.group_idx.long()
    r = torch.stack(math3d.quat_to_mat9(quats), dim=-1)[gi]  # [M, 9]
    mat, comg = batch.mat_coords, com[gi]
    projected = torch.stack(
        [r[:, 3 * i] * mat[:, 0] + r[:, 3 * i + 1] * mat[:, 1] + r[:, 3 * i + 2] * mat[:, 2]
         + comg[:, i] for i in range(3)], dim=-1)
    return projected, quats


def shape_rows_plain(x: torch.Tensor, mass: torch.Tensor, quats: torch.Tensor,
                     batch: GroupBatch, rotation_iterations: int, failed=None,
                     out=None) -> torch.Tensor:
    """Plain twin of T13's shape kernel: the update rows f32[M, 3] of
    ``assemble_force``'s shape scatter (``assembly.py:275-278``), each
    member's projection times ``w[group]·mask``; ``quats`` f32[G, 4] takes
    the new rotations in place, unless slot 0 of ``failed`` is set.  An
    ensemble (``x`` f32[B, N, 3], ``quats`` f32[B, G, 4]) runs member by
    member."""
    if members_of(x):
        return _twin_rows(lambda xb, mb, qb, fb, ob: shape_rows_plain(
            xb, mb, qb, batch, rotation_iterations, fb, ob), x, out, mass, quats, failed)
    projected, new = project_shape(x, mass, quats, batch, rotation_iterations)
    if failed is not None:
        new = torch.where(failed[0] != 0, quats, new)
    quats.copy_(new)
    return _store(out, _member_weights(batch)[:, None] * projected)


def shape_rows(x: torch.Tensor, mass: torch.Tensor, quats: torch.Tensor, batch: GroupBatch,
               rotation_iterations: int, failed=None, out=None) -> torch.Tensor:
    """T13's shape kernel on a CUDA tensor, its twin on a CPU tensor; in
    place on ``quats``.  The two agree to the roundoff of ``sin`` and
    ``cos``."""
    if kernels.on_cpu(x):
        return shape_rows_plain(x, mass, quats, batch, rotation_iterations, failed, out)
    if failed is None:
        raise ValueError("the shape-matching kernel needs the failure latch")
    m, g = batch.node_idx.shape[0], batch.num_groups
    lead = x.shape[:-2]
    if tuple(quats.shape) != lead + (g, 4) or batch.member_start.shape[0] != g + 1:
        raise ValueError(f"{g} groups need quats {list(lead + (g, 4))} and {g + 1} member"
                         " starts")
    rows = _rows_out(out, m, x, members_of(x))
    stride = kernels.row_stride(x.device, rows)
    b = (batch.node_idx, batch.mat_coords, batch.member_mask, batch.member_start, batch.w,
         batch.group_mask, batch.inv_count, batch.qinv)
    kernels.require(x.device, x, mass, quats, failed, *b)
    err = kernels.lib().pies_shape_rows(
        x.data_ptr(), mass.data_ptr(), *(t.data_ptr() for t in b), quats.data_ptr(),
        rows.data_ptr(), m, g, int(rotation_iterations), failed.data_ptr(), x.shape[-2],
        stride, kernels.launch_members(x, failed, mass), kernels.stream())
    kernels.check(err, "shape_rows")
    shape_rows.launches += 1
    return rows


shape_rows.launches = 0


def project_goal(batch: GroupBatch) -> torch.Tensor:
    """Goal-matching projection f32[M, 3] (``projections.py:488-504``,
    ``ShapeMatchingConstraint.cpp:162-173``): ``p = T·(mat, 1)`` with the
    group's 4x4 transform, which the host updates
    (``Solver.update_fixed_regions``)."""
    t16 = batch.transforms.reshape(-1, 16)[batch.group_idx.long()]
    mat = batch.mat_coords
    return torch.stack(
        [t16[:, 4 * i] * mat[:, 0] + t16[:, 4 * i + 1] * mat[:, 1]
         + t16[:, 4 * i + 2] * mat[:, 2] + t16[:, 4 * i + 3] for i in range(3)], dim=-1)


def goal_rows_plain(batch: GroupBatch, failed=None, out=None) -> torch.Tensor:
    """Plain twin of T13's goal kernel: the update rows f32[M, 3] of
    ``assemble_force``'s goal scatter, ``w[group]·mask·T·(mat, 1)``; into an
    ensemble's ``out`` f32[B, M, 3] member by member (the transforms are
    shared)."""
    if out is not None and out.dim() == 3:
        for b in range(out.shape[0]):
            goal_rows_plain(batch, None if failed is None else failed[b], out[b])
        return out
    return _store(out, _member_weights(batch)[:, None] * project_goal(batch))


def goal_rows(batch: GroupBatch, failed=None, out=None) -> torch.Tensor:
    """T13's goal kernel on CUDA tensors, its twin on CPU tensors; an
    ensemble's rows ``out`` f32[B, M, 3] with its latch ``failed`` i32[B,
    2] in one launch."""
    if kernels.on_cpu(batch.mat_coords):
        return goal_rows_plain(batch, failed, out)
    if failed is None:
        raise ValueError("the goal-matching kernel needs the failure latch")
    m = batch.node_idx.shape[0]
    members = out.shape[0] if out is not None and out.dim() == 3 else 0
    if failed.shape[:-1] != ((members,) if members else ()):
        raise ValueError("the latch needs the rows' member axis")
    rows = _rows_out(out, m, batch.mat_coords, members)
    stride = kernels.row_stride(rows.device, rows)
    b = (batch.group_idx, batch.mat_coords, batch.member_mask, batch.w, batch.transforms)
    kernels.require(rows.device, failed, *b)
    err = kernels.lib().pies_goal_rows(
        *(t.data_ptr() for t in b), rows.data_ptr(), m, failed.data_ptr(), stride,
        max(members, 1), kernels.stream())
    kernels.check(err, "goal_rows")
    goal_rows.launches += 1
    return rows


goal_rows.launches = 0


# ---------------------------------------------------------------------------
# PBD projections and T18's stage 1: the Jacobi families' update rows

PBD_KINDS = {"position": 0, "distance": 1, "strain": 2, "bend": 3}


def pbd_direction(pa, pb):
    """``(dir, dist)`` of the PBD distance projection
    (``pies_tpu/solver/pbd.py:104-112``): ``dir = (pb − pa) / max(dist,
    1e-20)`` (an IEEE division per component), ``(1, 0, 0)`` when ``dist ≤
    1e-5``; ``dir`` a list of three f32[C] columns."""
    df = [pb[:, d] - pa[:, d] for d in range(3)]
    dist = torch.sqrt(df[0] * df[0] + df[1] * df[1] + df[2] * df[2])
    safe = dist > 1e-5
    den = torch.clamp_min(dist, 1e-20)
    return [torch.where(safe, df[d] / den, 1.0 if d == 0 else 0.0) for d in range(3)], dist


def project_distance(x: torch.Tensor, batch: DistanceBatch) -> torch.Tensor:
    """The PBD distance projection (``projections.py:25-45``,
    ``Constraints.cpp:11-37``): only node 0 moves, by the full ``−(rest −
    dist)·dir``.  Returns the projected pair f32[C, 2, 3]."""
    idx = batch.idx.long()
    pa, pb = x[idx[:, 0]], x[idx[:, 1]]
    dirs, dist = pbd_direction(pa, pb)
    disp = batch.rest - dist
    proj0 = torch.stack([pa[:, d] - disp * dirs[d] for d in range(3)], dim=1)
    return torch.stack([proj0, pb], dim=1)


def project_position(batch: PositionBatch) -> torch.Tensor:
    """Pin to the stored position (``projections.py:80``)."""
    return batch.target


def project_strain(x: torch.Tensor, batch: TetBatch, recenter: bool = False) -> torch.Tensor:
    """Strain limiting (``projections.py:119``, ``Constraints.cpp:76-128``):
    the singular values of ``F = P·Qinv`` clamped to ``[lo, hi]``, the
    third negated on an inverted tet; the projected tet in differential
    coordinates ``(0, F̂e₁, F̂e₂, F̂e₃)``, f32[C, 4, 3].  ``recenter`` moves
    it onto the current centroid (``pbd.py:167-169``, the PBD step without
    the reference's quirks).  The SVD is the flat one of T1
    (``ops/math3d.svd3x3_flat``)."""
    idx = batch.idx.long()
    p = [[x[idx[:, a], d] for d in range(3)] for a in range(4)]
    e = [[p[k + 1][d] - p[0][d] for d in range(3)] for k in range(3)]
    qf = tuple(batch.qinv[r] for r in range(9))
    f = tuple(e[0][d] * qf[0 + j] + e[1][d] * qf[3 + j] + e[2][d] * qf[6 + j]
              for d in range(3) for j in range(3))
    u, sigma, v = math3d.svd3x3_flat(f)
    s = [torch.clamp(sk, batch.lo, batch.hi) for sk in sigma]
    s[2] = s[2] * torch.where(math3d.det3x3_flat(f) < 0.0, -1.0, 1.0)
    fhat = [u[3 * d + 0] * s[0] * v[3 * j + 0] + u[3 * d + 1] * s[1] * v[3 * j + 1]
            + u[3 * d + 2] * s[2] * v[3 * j + 2] for d in range(3) for j in range(3)]
    zero = torch.zeros_like(fhat[0])
    ps = [[zero] * 3] + [[fhat[3 * d + a] for d in range(3)] for a in range(3)]
    if recenter:
        for d in range(3):
            m = _div(zero + ps[1][d] + ps[2][d] + ps[3][d], 4.0)
            c = _div(p[0][d] + p[1][d] + p[2][d] + p[3][d], 4.0)
            for a in range(4):
                ps[a][d] = (ps[a][d] - m) + c
    return torch.stack([torch.stack(ps[a], dim=1) for a in range(4)], dim=1)


def _entries(delta: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """``(delta, live)`` rows f32[E, 4] from f32[C, k, 3] and bool[C, k]."""
    delta = torch.where(live[..., None], delta, 0.0)
    return torch.cat([delta, live.to(delta.dtype)[..., None]], dim=-1).reshape(-1, 4)


def jacobi_rows_plain(kind: str, x: torch.Tensor, inv_mass: torch.Tensor, batch,
                      w_scale: float = 1.0, recenter: bool = False,
                      failed=None) -> torch.Tensor:
    """Plain twin of T18's stage 1: one PBD Jacobi family's update rows
    f32[C·k, 4], row ``c·k + j`` the ``w·(projected − x[idx])`` of slot j
    of constraint c and its live flag (``_apply_jacobi``,
    ``pies_tpu/solver/pbd.py:32-53``).  ``kind``: "position" (k = 1, the
    pins, ``w·w_scale`` with ``w_scale = 1 − release_hinge``), "distance"
    (k = 1: slot 0 of each pair, the only node that moves), "strain"
    (k = 4, ``recenter`` off the quirks) or "bend" (k = 4).  ``failed`` is
    accepted for signature parity.  An ensemble (``x`` f32[B, N, 3]) gives
    each member's rows, f32[B, C·k, 4]."""
    if members_of(x):
        return each_member(lambda xb, mb: jacobi_rows_plain(kind, xb, mb, batch, w_scale,
                                                            recenter),
                           members_of(x), x, inv_mass)
    idx = batch.idx.long()
    if kind == "position":
        w = batch.w * w_scale
        delta = (w[:, None] * (project_position(batch) - x[idx]))[:, None]
    elif kind == "distance":
        w = batch.w
        pa = x[idx[:, 0]]
        delta = (w[:, None] * (project_distance(x, batch)[:, 0] - pa))[:, None]
    elif kind == "strain":
        w = batch.w
        delta = w[:, None, None] * (project_strain(x, batch, recenter) - x[idx])
    elif kind == "bend":
        w = batch.w
        delta = w[:, None, None] * (project_bend(x, inv_mass, batch) - x[idx])
    else:
        raise ValueError(f"no PBD family {kind!r}")
    live = (w > 0)[:, None].expand(delta.shape[:2])
    return _entries(delta, live)


def jacobi_rows(kind: str, x: torch.Tensor, inv_mass: torch.Tensor, batch,
                w_scale: float = 1.0, recenter: bool = False,
                failed=None) -> torch.Tensor:
    """T18's stage 1 (``kernels/csrc/pbd_constraints.cu``) on a CUDA tensor
    (one launch for all members of an ensemble), :func:`jacobi_rows_plain`
    on a CPU tensor.  The kernel returns at once when latch slot 0 is set
    (a latched member's rows are left unwritten)."""
    if kernels.on_cpu(x):
        return jacobi_rows_plain(kind, x, inv_mass, batch, w_scale, recenter, failed)
    if failed is None:
        raise ValueError("the PBD row kernel needs the failure latch")
    c = batch.idx.shape[0]
    k = 4 if kind in ("strain", "bend") else 1
    members = kernels.launch_members(x, failed, inv_mass)
    vals = torch.empty(x.shape[:-2] + (c * k, 4), dtype=torch.float32, device=x.device)
    fields = {"position": ("target",), "distance": ("rest",), "strain": ("qinv", "lo", "hi"),
              "bend": ("rest_angle",)}[kind]
    a, b, cc = ([getattr(batch, f) for f in fields] + [None, None])[:3]
    kernels.require(x.device, x, inv_mass, batch.idx, batch.w, a, b, cc, vals, failed)
    err = kernels.lib().pies_pbd_rows(
        PBD_KINDS[kind], x.data_ptr(), inv_mass.data_ptr(), batch.idx.data_ptr(),
        kernels.ptr(a), kernels.ptr(b), kernels.ptr(cc), batch.w.data_ptr(), vals.data_ptr(),
        c, x.shape[-2], float(w_scale), int(recenter), failed.data_ptr(), members,
        kernels.stream())
    kernels.check(err, "pbd_rows")
    jacobi_rows.launches += 1
    return vals


jacobi_rows.launches = 0
