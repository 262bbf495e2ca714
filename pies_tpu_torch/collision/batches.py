"""Per-substep collision constraints (port of the floor and point-triangle
parts of ``pies_tpu/collision/batches.py``).

Weights mirror the reference headers.  Point-triangle contacts come from
the detection as a fixed-capacity buffer whose live entries are a packed
prefix of ``pt_count`` (a device scalar).  Every per-node sum over contacts
goes through the node incidence (:class:`Incidence`): the (column, contact)
entries ``e = a·cap + i`` grouped by node, each node's list in ascending
``e`` — the order in which the JAX package's scatter of ``idx.T.reshape(-1)``
adds on the CPU — so the sums are deterministic on every device and need no
float atomics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.math3d import ieee_div as _div

W_POINT_TRI = 1.0e4  # PointTriangleCollisionConstraint (CollisionConstraint.h:33)
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
    ``e = a·cap + i`` is column a of contact i; ``entries[row_start[n] :
    row_start[n+1]]`` are node n's entries in ascending order, and
    ``nodes[p]`` is the node of position p.  Positions past ``row_start[N]``
    are unused."""

    row_start: torch.Tensor  # i32[N + 1]
    entries: torch.Tensor  # i32[4·cap]
    nodes: torch.Tensor  # i32[4·cap]
    cap: int


def incidence_plain(pt_idx: torch.Tensor, pt_count: torch.Tensor, n_nodes: int) -> Incidence:
    """Plain twin of T7's incidence stages (count, scan, fill, order)."""
    cap = pt_idx.shape[0]
    live = int(pt_count[0])
    dev = pt_idx.device
    e = torch.arange(4 * cap, dtype=torch.int64, device=dev).view(4, cap)[:, :live].reshape(-1)
    node = pt_idx[:live].t().reshape(-1).long()
    order = torch.sort(node, stable=True).indices
    deg = torch.bincount(node, minlength=n_nodes)
    row_start = torch.zeros(n_nodes + 1, dtype=torch.int64, device=dev)
    row_start[1:] = torch.cumsum(deg, 0)
    entries = torch.zeros(4 * cap, dtype=torch.int32, device=dev)
    nodes = torch.zeros(4 * cap, dtype=torch.int32, device=dev)
    entries[: e.numel()] = e[order].to(torch.int32)
    nodes[: e.numel()] = node[order].to(torch.int32)
    return Incidence(row_start.to(torch.int32), entries, nodes, cap)


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
