"""Per-substep collision constraints (port of
``pies_tpu/collision/batches.py``: the floor, point-triangle, edge-edge and
node-node constraints).

Weights mirror the reference headers.  Contacts come from the detection as
fixed-capacity buffers whose live entries are a packed prefix of a device
count.  Every per-node sum over contacts goes through a node incidence
(:class:`Incidence`): the (column, contact) entries grouped by node, each
node's list in ascending entry id.  Point-triangle entries are ``e =
a·cap + i``, the order in which the JAX package's scatter of
``idx.T.reshape(-1)`` adds on the CPU; edge and node-pair entries are ``e =
w·i + a`` (``w`` the columns), the order of its scatters of ``idx`` itself,
and :func:`column_order` gives the ``idx.T`` order of the same entries.  So
the sums are deterministic on every device and need no float atomics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.math3d import ieee_div as _div

W_NODE_NODE = 1.0e5  # CollisionConstraint (CollisionConstraint.h:14)
W_POINT_TRI = 1.0e4  # PointTriangleCollisionConstraint (CollisionConstraint.h:33)
W_EDGE = 1.0e6  # EdgeCollisionConstraint (CollisionConstraint.h:56)
W_STATIC = 1.0e4  # StaticCollisionConstraint, the floor (CollisionConstraint.h:78)

# AᵀA of the point-triangle / edge collision differential matrix
# A = [[0,0,0,0],[-1,1,0,0],[-1,0,1,0],[-1,0,0,1]]
# (CollisionConstraint.cpp:74-84,202-211).
ATA_DIFF4 = np.array(
    [
        [3.0, -1.0, -1.0, -1.0],
        [-1.0, 1.0, 0.0, 0.0],
        [-1.0, 0.0, 1.0, 0.0],
        [-1.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)


@dataclass
class CollisionSet:
    """The constraints detected for one substep: the floor contacts and,
    with self-contact on, the point-triangle contacts (node a against
    triangle (b, c, d) of another body, ``Solver.cpp:777-797``) and the
    capacity latch.

    The floor comes in two forms.  Dense (``StepConfig.dense_floor``): the
    per-node activity ``floor_active``.  Entry list: one entry per triangle
    corner (``static_idx``, ``static_mask``, ``Solver.cpp:829-834``), with
    ``floor_active`` the per-node snap flag (1 where any entry of the node
    is live) and ``floor_counts`` its live entries (the friction's
    exponent), both summed through the topology's corner incidence."""

    floor_active: torch.Tensor  # f32[N]
    pt_idx: torch.Tensor | None = None  # i32[cap, 4]
    pt_mask: torch.Tensor | None = None  # f32[cap]
    pt_count: torch.Tensor | None = None  # i32[1] live prefix length
    overflow: torch.Tensor | None = None  # i32[1], a capacity was exceeded
    rebuilt: torch.Tensor | None = None  # i32[1], the broadphase cache was rebuilt
    static_idx: torch.Tensor | None = None  # i32[3T] entry list: each corner's node
    static_mask: torch.Tensor | None = None  # f32[3T] entry list: the live entries
    floor_counts: torch.Tensor | None = None  # f32[N] entry list: live entries per node
    # Edge-edge contacts (StepConfig.enable_edge_collisions): nodes (a, b |
    # c, d), a packed prefix of edge_count; edge_hits counts the hits
    # before the cap (the JAX package drops the rest without a latch).
    edge_idx: torch.Tensor | None = None  # i32[E, 4]
    edge_mask: torch.Tensor | None = None  # f32[E]
    edge_count: torch.Tensor | None = None  # i32[1]
    edge_hits: torch.Tensor | None = None  # i32[1]
    # PD node-node pairs (StepConfig.enable_node_collisions): the pair
    # prefix of a freshly built state.NodePairCache, of which the first
    # min(count, nn_cap) pairs are the contacts.
    nn: object = None
    nn_cap: int = 0


def floor_threshold(params) -> float:
    """``floor_height + thickness`` rounded as the float32 sum the JAX
    package computes on the device."""
    return float(np.float32(params.floor_height) + np.float32(params.collision_thickness))


def detect_floor_active(positions: torch.Tensor, floor_count: torch.Tensor,
                        threshold: float) -> torch.Tensor:
    """Per node, 1.0 when it has live incident triangles and
    ``y < floorHeight + thickness`` (``Solver.cpp:829-834``, hoisted to the
    node).  Returns ``f32[N]``."""
    hit = (positions[:, 1] < threshold) & (floor_count > 0)
    return hit.to(positions.dtype)


def detect_floor_contacts(positions: torch.Tensor, triangles: torch.Tensor,
                          tri_mask: torch.Tensor, threshold: float):
    """Floor contact entries as the PD sweep emits them
    (``batches.py:104-124``, ``Solver.cpp:829-834``): every corner of every
    triangle with ``y < floorHeight + thickness``, a node shared by k
    triangles k times.  Returns ``(static_idx i32[3T], static_mask
    f32[3T])``, entry ``e = 3·triangle + corner``."""
    corner_idx = triangles.reshape(-1)
    y = positions[corner_idx.long(), 1]
    hit = (y < threshold) & (torch.repeat_interleave(tri_mask, 3) > 0)
    return corner_idx, hit.to(positions.dtype)


def project_static(positions: torch.Tensor, static_idx: torch.Tensor,
                   plane: float) -> torch.Tensor:
    """The floor projection at the entries (``batches.py:230-245``): each
    entry's node with y clamped to ``plane`` (``floor_plane``).  Returns
    f32[S, 3]."""
    p = positions[static_idx.long()]
    y = p[:, 1]
    return torch.stack([p[:, 0], torch.where(y < plane, plane, y), p[:, 2]], dim=1)


def floor_plane(params, reference_quirks: bool) -> float:
    """The plane the floor projection clamps to.  Quirk mode uses y = 0
    whatever the floor height, as the reference does
    (``CollisionConstraint.cpp:447-455``; FIDELITY.md), while detection uses
    the floor height."""
    return 0.0 if reference_quirks else params.floor_height


@dataclass
class Incidence:
    """Node → contact-entry incidence (CSR) of the live contacts.  Entry
    ``e = a·cap + i`` (point-triangle) or ``e = w·i + a`` (row-major: edges,
    node pairs) is column a of contact i; ``entries[row_start[n] :
    row_start[n+1]]`` are node n's entries in ascending order, and
    ``nodes[p]`` is the node of position p.  Positions past ``row_start[N]``
    are unused.  T7's setup on the card also lists the incident nodes,
    ascending, in ``node_list[: node_count[0]]``, which its force kernel
    strides over."""

    row_start: torch.Tensor  # i32[N + 1]
    entries: torch.Tensor  # i32[w·cap]
    nodes: torch.Tensor  # i32[w·cap]
    cap: int
    node_list: torch.Tensor | None = None  # i32[w·cap]
    node_count: torch.Tensor | None = None  # i32[1]


def incidence_plain(idx: torch.Tensor, count: torch.Tensor | int, n_nodes: int,
                    row_major: bool = False) -> Incidence:
    """Plain twin of the incidence stages of T7 (``e = a·cap + i``) and,
    with ``row_major``, of T26 (``e = w·i + a``): count, scan, fill, order
    over the first ``count`` rows of ``idx`` i32[cap, w]."""
    cap, w = idx.shape
    live = int(count[0]) if isinstance(count, torch.Tensor) else int(count)
    dev = idx.device
    ids = torch.arange(w * cap, dtype=torch.int64, device=dev)
    if row_major:
        e = ids[: w * live]
        node = idx[:live].reshape(-1).long()
    else:
        e = ids.view(w, cap)[:, :live].reshape(-1)
        node = idx[:live].t().reshape(-1).long()
    order = torch.sort(node, stable=True).indices
    deg = torch.bincount(node, minlength=n_nodes)
    row_start = torch.zeros(n_nodes + 1, dtype=torch.int64, device=dev)
    row_start[1:] = torch.cumsum(deg, 0)
    entries = torch.zeros(w * cap, dtype=torch.int32, device=dev)
    nodes = torch.zeros(w * cap, dtype=torch.int32, device=dev)
    entries[: e.numel()] = e[order].to(torch.int32)
    nodes[: e.numel()] = node[order].to(torch.int32)
    return Incidence(row_start.to(torch.int32), entries, nodes, cap)


def column_order(inc: Incidence, w: int) -> Incidence:
    """The row-major incidence ``inc`` (``e = w·i + a``) with each node's
    entries in column-major order, by ``(a, i)``: the order of the JAX
    package's scatters over ``idx.T.reshape(-1)``.  Entry ids stay
    row-major."""
    total = int(inc.row_start[-1])
    e = inc.entries[:total].long()
    key = (e % w) * inc.cap + e // w
    order = torch.sort(key, stable=True).indices
    order = order[torch.sort(inc.nodes[:total][order], stable=True).indices]
    entries = inc.entries.clone()
    entries[:total] = inc.entries[:total][order]
    return Incidence(inc.row_start, entries, inc.nodes, inc.cap)


def incident(inc: Incidence) -> torch.Tensor:
    """bool[N]: nodes with at least one live contact entry."""
    return inc.row_start[1:] > inc.row_start[:-1]


def csr_sum(inc: Incidence, vals: torch.Tensor, init: torch.Tensor | None = None) -> torch.Tensor:
    """Per node, the sum of ``vals[e]`` (``vals`` f32[E, w], indexed by
    entry) over its entries of ``inc``, added one after another in
    ascending ``e`` from 0.0, or from ``init`` f32[N, w] — the JAX package's
    CPU scatter order.  Returns f32[N, w]."""
    n = inc.row_start.shape[0] - 1
    start = inc.row_start[:-1].long()
    deg = inc.row_start[1:].long() - start
    out = (torch.zeros((n, vals.shape[1]), dtype=vals.dtype, device=vals.device)
           if init is None else init.clone())
    for r in range(int(deg.max()) if n else 0):
        nodes = torch.nonzero(deg > r).reshape(-1)
        out[nodes] = out[nodes] + vals[inc.entries[start[nodes] + r].long()]
    return out


def _gather4(x: torch.Tensor, pt_idx: torch.Tensor):
    return tuple(x[pt_idx[:, a].long()] for a in range(4))


def _unit_normal_div(b, c, d):
    """``n = (c−b)×(d−b) / max(|n|, 1e-20)`` with a division per component,
    as ``jnp.cross`` then ``n / max(norm, 1e-20)``."""
    e1, e2 = c - b, d - b
    nx = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
    ny = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
    nz = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    nn = torch.clamp_min(torch.sqrt(nx * nx + ny * ny + nz * nz), 1e-20)
    return torch.stack([_div(nx, nn), _div(ny, nn), _div(nz, nn)], dim=1)


def _dot3(u, v):
    return u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2]


def stabilize_contacts(positions, inv_mass, pt_idx, pt_mask, thickness):
    """Per-contact stabilization values (``CollisionConstraint.cpp:126-162``):
    the point's push-out ``da``, the triangle corners' ``dbcd`` (each of b, c,
    d takes the full share, as the reference does) and the activity.
    Returns f32[cap, 7] = (da, dbcd, active)."""
    a, b, c, d = _gather4(positions, pt_idx)
    n = _unit_normal_div(b, c, d)
    ndp = _dot3(n, a - b)
    active = (ndp < thickness) & (pt_mask > 0)
    disp = torch.where(active, thickness - ndp, 0.0)[:, None] * n
    im = inv_mass[pt_idx.long()]
    w_tri = im[:, 1] + im[:, 2] + im[:, 3]
    inv_w = _div(torch.ones_like(w_tri), torch.clamp_min(im[:, 0] + w_tri, 1e-20))
    da = disp * (im[:, 0] * inv_w)[:, None]
    dbcd = -disp * (w_tri * inv_w)[:, None]
    return torch.cat([da, dbcd, active.to(positions.dtype)[:, None]], dim=1)


def entry_values(per_contact: torch.Tensor) -> torch.Tensor:
    """Expand per-contact ``(point xyz, corner xyz, count)`` rows f32[cap, 7]
    to per-entry ``(xyz, count)`` rows f32[4·cap, 4]: column 0 takes the
    point's values, columns 1-3 the corners'."""
    pt = torch.cat([per_contact[:, 0:3], per_contact[:, 6:7]], dim=1)
    tri = torch.cat([per_contact[:, 3:6], per_contact[:, 6:7]], dim=1)
    return torch.cat([pt, tri, tri, tri], dim=0)


def stabilize_point_tri_acc(positions, inv_mass, pt_idx, pt_mask, thickness) -> torch.Tensor:
    """The stabilization pass's ``[N, 4]`` accumulator (xyz delta sums and
    contact counts) over every entry of the buffer, before count-averaging
    (``batches.py:501-549``)."""
    count = torch.full((1,), pt_idx.shape[0], dtype=torch.int32, device=pt_idx.device)
    inc = incidence_plain(pt_idx, count, positions.shape[0])
    vals = stabilize_contacts(positions, inv_mass, pt_idx, pt_mask, thickness)
    return csr_sum(inc, entry_values(vals))


def project_point_tri(positions: torch.Tensor, pt_idx: torch.Tensor,
                      thickness: float) -> torch.Tensor:
    """The point-triangle projection in its stack form (``batches.py:286-330``,
    ``build_stack=True``, ``CollisionConstraint.cpp:86-124``): within
    ``thickness`` of the triangle's plane the point moves out along the unit
    normal to ``thickness``, the corners stay.  Returns f32[K, 4, 3]."""
    a, b, c, d = _gather4(positions, pt_idx)
    n = _unit_normal_div(b, c, d)
    ndp = _dot3(n, a - b)
    disp = torch.where(ndp < thickness, thickness - ndp, 0.0)
    return torch.stack([a + disp[:, None] * n, b, c, d], dim=1)


def count_average(acc: torch.Tensor) -> torch.Tensor:
    """``acc[:, :3] / max(acc[:, 3], 1)``, the Jacobi count-averaging."""
    return _div(acc[:, :3], torch.clamp_min(acc[:, 3:4], 1.0))


# ---------------------------------------------------------------------------
# edge-edge contacts (the plain twins of kernel T26's device functions)

ATA_DIAG4 = [float(ATA_DIFF4[a, a]) for a in range(4)]


def _norm3(v):
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])


def edge_closest_disp(q, inv_mass4: torch.Tensor, thickness: float, quirks: bool):
    """``_edge_edge_closest_disp`` (``batches.py:331-379``,
    ``CollisionConstraint.cpp:225-314,316-400``) for rows ``q`` f32[E, 4, 3]
    (edge 1 = (a, b), edge 2 = (c, d)) and their inverse masses f32[E, 4]:
    the closest points' parameters (u, v; with ``quirks`` u = v = 0 unless
    the segments are parallel), the push-out ``disp = (thickness − dist)·n``
    and the mass weights.  Returns ``(active bool[E], disp f32[E, 3], w
    f32[E, 4])``; a, b move by +w·disp and c, d by −w·disp."""
    from .narrowphase import segment_closest_uv

    a, b, c, d = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    cols = lambda v: (v[:, 0], v[:, 1], v[:, 2])  # noqa: E731
    ab, ac, ad = b - a, c - a, d - a
    u, v, degenerate = segment_closest_uv(cols(ab), cols(ac), cols(ad))
    if quirks:
        u = torch.where(degenerate, u, 0.0)
        v = torch.where(degenerate, v, 0.0)
    n = u[:, None] * ab - (ac + v[:, None] * (ad - ac))
    dist = _norm3(n)
    n = _div(n, torch.clamp_min(dist, 1e-20)[:, None])
    im = inv_mass4
    iu, iv = 1.0 - u, 1.0 - v
    s = ((im[:, 0] * (iu * iu) + im[:, 1] * (u * u)) + im[:, 2] * (iv * iv)) + im[:, 3] * (v * v)
    active = (dist < thickness) & (s > 0.0)
    disp = (thickness - dist)[:, None] * n
    inv_s = _div(torch.ones_like(s), torch.clamp_min(s, 1e-20))
    w = torch.stack([(im[:, 0] * iu) * inv_s, (im[:, 1] * u) * inv_s,
                     (im[:, 2] * iv) * inv_s, (im[:, 3] * v) * inv_s], dim=1)
    return active, disp, w


def project_edge_edge(positions, inv_mass, edge_idx, thickness: float, quirks: bool):
    """The edge-edge projection (``batches.py:381-420``): returns ``(proj,
    delta)`` f32[E, 4, 3], ``delta = proj − gathered``.  Quirk mode keeps
    the reference's sign, which moves the edges toward each other."""
    idx = edge_idx.long()
    q = positions[idx]
    active, disp, w = edge_closest_disp(q, inv_mass[idx], thickness, quirks)
    sign = -1.0 if quirks else 1.0
    am = active.to(positions.dtype)[:, None]
    delta = torch.stack([((sign * w[:, 0])[:, None] * disp) * am,
                         ((sign * w[:, 1])[:, None] * disp) * am,
                         ((-sign * w[:, 2])[:, None] * disp) * am,
                         ((-sign * w[:, 3])[:, None] * disp) * am], dim=1)
    return q + delta, delta


def stabilize_edges(positions, inv_mass, edge_idx, edge_mask, thickness: float,
                    quirks: bool) -> torch.Tensor:
    """Per-entry values of one edge-edge stabilization pass
    (``batches.py:445-476``): f32[4E, 4] rows ``e = 4·i + a`` of (xyz push,
    count), zero where the contact is not active."""
    idx = edge_idx.long()
    active, disp, w = edge_closest_disp(positions[idx], inv_mass[idx], thickness, quirks)
    am = (active & (edge_mask > 0)).to(positions.dtype)[:, None]
    sgn = (1.0, 1.0, -1.0, -1.0)
    rows = torch.stack([torch.cat([((sgn[a] * w[:, a])[:, None] * disp) * am, am], dim=1)
                        for a in range(4)], dim=1)
    return rows.reshape(-1, 4)


def stabilize_edge_edge_acc(positions, inv_mass, edge_idx, edge_mask, thickness: float,
                            quirks: bool) -> torch.Tensor:
    """The pass's ``[N, 4]`` accumulator over every entry of the buffer in
    the JAX package's ``idx.T`` order, before count-averaging."""
    n = positions.shape[0]
    inc = column_order(incidence_plain(edge_idx, edge_idx.shape[0], n, row_major=True), 4)
    return csr_sum(inc, stabilize_edges(positions, inv_mass, edge_idx, edge_mask, thickness,
                                        quirks))


def ata_rows(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``w·(AᵀA q)[a]`` for rows ``q`` f32[K, 4, 3] and weights f32[K]:
    f32[K, 4, 3], each row's four terms summed in order (T23, T26)."""
    out = []
    for a in range(4):
        c = [float(ATA_DIFF4[a, b]) for b in range(4)]
        r = ((c[0] * q[:, 0] + c[1] * q[:, 1]) + c[2] * q[:, 2]) + c[3] * q[:, 3]
        out.append(w[:, None] * r)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# node-node contacts (the plain twins of kernel T27's device functions)


def node_pairs_of(nn, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(nn_idx i32[cap, 2], nn_mask f32[cap])`` of a pair prefix, the JAX
    package's ``detect_node_node_pairs`` result: the first ``min(count,
    cap)`` pairs, then rows (0, 0) with mask 0."""
    live = min(int(nn.count[0]), cap)
    dev = nn.pi.device
    idx = torch.zeros((cap, 2), dtype=torch.int32, device=dev)
    idx[:live, 0] = nn.pi[:live]
    idx[:live, 1] = nn.pj[:live]
    mask = torch.zeros(cap, dtype=torch.float32, device=dev)
    mask[:live] = 1.0
    return idx, mask


def project_node_node(positions, radius, inv_mass, nn_idx) -> torch.Tensor:
    """The node-node projection (``batches.py:248-284``,
    ``CollisionConstraint.cpp:10-39``): overlapping spheres pushed apart
    along their centre line, inverse-mass weighted, with the reference's
    ``(dispLength, 0, 0)`` for coincident centres.  Returns f32[P, 2, 3]."""
    i, j = nn_idx[:, 0].long(), nn_idx[:, 1].long()
    a, b = positions[i], positions[j]
    diff = b - a
    dist_sq = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2]
    r = radius[i] + radius[j]
    overlapping = dist_sq < r * r
    dist = torch.sqrt(torch.clamp_min(dist_sq, 0.0))
    disp_len = r - dist
    zero = torch.zeros_like(disp_len)
    disp = torch.where((dist > 1e-5)[:, None],
                       _div(disp_len[:, None] * diff, torch.clamp_min(dist, 1e-20)[:, None]),
                       torch.stack([disp_len, zero, zero], dim=1))
    w_sum = torch.clamp_min(inv_mass[i] + inv_mass[j], 1e-20)
    ov = overlapping.to(positions.dtype)[:, None]
    a_proj = a - (ov * disp) * _div(inv_mass[i], w_sum)[:, None]
    b_proj = b + (ov * disp) * _div(inv_mass[j], w_sum)[:, None]
    return torch.stack([a_proj, b_proj], dim=1)


def node_friction_pairs(x, vel, inv_mass, radius, nn_idx, nn_mask, friction: float,
                        static_threshold: float) -> torch.Tensor:
    """Per-pair values of the node-node friction pass
    (``pd.py:452-508``, ``Solver.cpp:398-428``): f32[P, 7] = (a's impulse,
    b's impulse, touching).  The static branch keeps the reference's sign
    (FIDELITY.md #18)."""
    i, j = nn_idx[:, 0].long(), nn_idx[:, 1].long()
    diff = x[j] - x[i]
    dist = _norm3(diff)
    touching = (dist <= radius[i] + radius[j]) & (nn_mask > 0)
    n = _div(diff, torch.clamp_min(dist, 1e-20)[:, None])
    rel = vel[j] - vel[i]
    vdn = rel[:, 0] * n[:, 0] + rel[:, 1] * n[:, 1] + rel[:, 2] * n[:, 2]
    perp = rel - vdn[:, None] * n
    fr = torch.where(_norm3(perp) < static_threshold, -1.0, friction)
    w_sum = torch.clamp_min(inv_mass[i] + inv_mass[j], 1e-20)
    fp = fr[:, None] * perp
    m = touching.to(x.dtype)[:, None]
    dva = (fp * _div(inv_mass[i], w_sum)[:, None]) * m
    dvb = (-fp * _div(inv_mass[j], w_sum)[:, None]) * m
    return torch.cat([dva, dvb, m], dim=1)
