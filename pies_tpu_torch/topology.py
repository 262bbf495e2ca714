"""Constraint topology of the ported PD paths (port of ``pies_tpu/topology.py``).

Built on the host in NumPy at scene-construction time, exactly as the JAX
package builds it, then moved to tensors once with :func:`to_device`.  Only
the batches and precomputed fields that the ported paths read are carried:
the distance, pin, strain, volume and bend batches, the shape- and
goal-matching groups, the surface triangles with their live mask (padded to
a multiple of 8, as in the JAX package), the constant stiffness diagonal,
the per-node floor-contact multiplicity, the disjoint-tet block
off-diagonals and the folded pin force.

Four things are the port's own, for scenes off the tet-column path:

* ``static_w``, the diagonal terms of the operator (pins, bends, shape and
  goal members: A = I for each) as one weight per node;
* the assembled operator ``Σ w·AᵀA`` of the distance constraints (a weighted
  graph Laplacian) and the tets (``w·GᵀG``), coalesced in float64: slot-major
  ELL while no row has more than 64 entries, CSR beyond; on a banded
  (element-major) tet soup the tets stay out of it, as the JAX package's
  seven diagonals ``tet_band``;
* ``row_inc``, the node → row incidence (a ``collision.batches.Incidence``)
  over the force rows of all families, which sums them per node in the JAX
  scatters' order without float atomics (:func:`row_layout`);
* ``corner_inc``, the node → triangle-corner incidence that the entry-list
  floor (``StepConfig.dense_floor=False``) sums its entries through
  (:func:`corner_incidence`).

A PBD scene also carries the rope chains (``ChainBatch``, as in the JAX
package) and, the port's own, the node → entry incidences of its Jacobi
families (:func:`pbd_incidences`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .collision.batches import Incidence

_F32 = np.float32
_I32 = np.int32


def _round_up(n: int, m: int) -> int:
    # Empty batches stay size 0, as in the JAX package.
    if n == 0:
        return 0
    return -(-n // m) * m


def _pad2(a: np.ndarray, cap: int, fill=0) -> np.ndarray:
    out = np.full((cap,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


@dataclass
class DistanceBatch:
    """``DistanceConstraint`` batch (``Constraints.h:147-157``);
    ``A = B = [[.5,-.5],[-.5,.5]]``."""

    idx: torch.Tensor  # i32[C, 2]
    rest: torch.Tensor  # f32[C], rest length captured at creation
    w: torch.Tensor  # f32[C]; 0 = padding


@dataclass
class PositionBatch:
    """``PositionConstraint`` batch (``Constraints.h:159-169``); A = B = I."""

    idx: torch.Tensor  # i32[C]
    target: torch.Tensor  # f32[C, 3]
    w: torch.Tensor  # f32[C]


@dataclass
class TetBatch:
    """Strain / volume tet batch (``Constraints.h:171-213``).

    ``qinv`` and ``g`` are stored transposed-flat as in the JAX package: row
    ``3i+j`` of ``qinv`` is entry (i, j) of the rest-edge inverse for every
    tet, row ``4j+a`` of ``g`` is entry (j, a) of G.  On the GPU this is also
    the coalesced layout: neighbouring tets read neighbouring words.
    """

    idx: torch.Tensor  # i32[C, 4]
    qinv: torch.Tensor  # f32[9, C]
    g: torch.Tensor  # f32[12, C]
    lo: torch.Tensor  # f32[C]
    hi: torch.Tensor  # f32[C]
    w: torch.Tensor  # f32[C]


@dataclass
class BendBatch:
    """``BendConstraint`` batch (``Constraints.h:215-230``); A = B = I₄."""

    idx: torch.Tensor  # i32[C, 4]: (x1, x2, x3, x4), (x2, x3) the shared edge
    rest_angle: torch.Tensor  # f32[C]
    w: torch.Tensor  # f32[C]


@dataclass
class ChainBatch:
    """Chain-structured PBD distance constraints (``pies_tpu/topology.py:121``):
    when every constraint writes a node no other one writes, consecutive
    constraints chase each other (``idx1[j] == idx0[j-1]``) and no chain's
    anchor is written, the set splits into node-disjoint chains (ropes),
    projected exactly in emission order by a walk down each chain.  Chains
    are padded to the longest with ``w = 0`` links."""

    idx0: torch.Tensor  # i32[C, L] written node per link, in chain order
    anchor: torch.Tensor  # i32[C] the chase root (never written)
    rest: torch.Tensor  # f32[C, L]
    w: torch.Tensor  # f32[C, L], 0 on padding links


@dataclass
class JacobiIncidence:
    """The port's node → entry incidences of the PBD Jacobi families
    (:func:`jacobi_incidence`): entry ``e = c·k + j`` is slot j of row c of
    a family's ``idx [C, k]``, each node's entries ascending, which is the
    order in which the JAX package's scatter of ``_apply_jacobi`` adds
    them."""

    position: Incidence
    distance: Incidence  # node 0 of each pair only (node 1 never moves)
    strain: Incidence
    bend: Incidence


@dataclass
class GroupBatch:
    """Flat ragged-group storage shared by shape and goal matching
    (``ShapeMatchingConstraint.h:15-60``), field for field the JAX package's,
    plus the port's ``member_start``: the groups are consecutive runs of the
    member list, group g owning members ``member_start[g] ..
    member_start[g+1] − 1``; members from ``member_start[G]`` on are padding
    (mask 0, group G − 1)."""

    node_idx: torch.Tensor  # i32[M], member -> node
    group_idx: torch.Tensor  # i32[M], member -> group
    mat_coords: torch.Tensor  # f32[M, 3]: centered (shape) or raw initial (goal)
    member_mask: torch.Tensor  # f32[M]
    w: torch.Tensor  # f32[G]
    group_mask: torch.Tensor  # f32[G]
    inv_count: torch.Tensor  # f32[G], 1 / member count (the COM weight)
    qinv: torch.Tensor  # f32[G, 3, 3] (shape; identity for goal)
    transforms: torch.Tensor  # f32[G, 4, 4] (goal; identity for shape)
    member_start: torch.Tensor  # i32[G + 1]
    max_count: int = 0  # the largest group's member count

    @property
    def num_groups(self) -> int:
        return self.w.shape[0]


@dataclass
class Topology:
    strain: TetBatch
    volume: TetBatch
    position: PositionBatch
    # Σ w·(AᵀA)ᵢᵢ over the static constraints, per node (no mass term).
    stiffness_diag: torch.Tensor  # f32[N]
    # Floor-contact multiplicity: (live triangle, corner) entries per node.
    floor_count: torch.Tensor  # f32[N]
    # Upper off-diagonals (0,1),(0,2),(0,3),(1,2),(1,3),(2,3) of each 4x4
    # disjoint-tet block; None when the block structure does not hold.
    tet_block6: torch.Tensor | None  # f32[6, N//4]
    # Σ w·target of the position pins per node; f32[1, 3] when no pins.
    position_force_dense: torch.Tensor  # f32[N, 3] or f32[1, 3]
    # Surface triangles (padded to a multiple of 8) and their live mask.
    triangles: torch.Tensor  # i32[T, 3]
    tri_mask: torch.Tensor  # f32[T]
    # Σ w of the diagonal-only constraints per node (pins, bends, shape and
    # goal members); f32[1] when the scene has none.
    static_w: torch.Tensor | None = None  # f32[N] or f32[1]
    # The assembled distance + strain + volume Σ w·AᵀA (on a banded tet
    # layout the tets are in ``tet_band`` instead).  ELL, slot-major (the
    # transpose of the JAX package's [N, m] arrays, so neighbouring nodes
    # read neighbouring words; m = 0 when the scene has no off-diagonal
    # term, a pure tet soup among them), or CSR when a row has more than 64
    # entries.
    ell_nbr: torch.Tensor | None = None  # i32[m, N]
    ell_coef: torch.Tensor | None = None  # f32[m, N]
    csr_start: torch.Tensor | None = None  # i32[N + 1]
    csr_col: torch.Tensor | None = None  # i32[nnz], ascending in each row
    csr_val: torch.Tensor | None = None  # f32[nnz]
    # The node → row incidence over the force rows of all families
    # (row_incidence); None where the operator is.
    row_inc: Incidence | None = None
    # Banded (element-major) live tets: the strain + volume Σ w·GᵀG as seven
    # diagonals, ``tet_band[3 + b − a][4t + a]`` entry (a, b) of tet t's
    # block (``pies_tpu/topology.py:563-588``); None off that layout.
    tet_band: torch.Tensor | None = None  # f32[7, N]
    # The node → triangle-corner incidence (corner_incidence); None without
    # triangles.
    corner_inc: Incidence | None = None
    # Super-body detection layout (``StepConfig.super_*``): node id per body
    # corner slot, and per row the rows sharing a node with it (−1 padded;
    # None when no two rows share a node).
    super_corners: torch.Tensor | None = None  # i32[K, W]
    super_adj: torch.Tensor | None = None  # i32[K, A]
    distance: DistanceBatch | None = None
    bend: BendBatch | None = None
    shape: GroupBatch | None = None
    goal: GroupBatch | None = None
    # Strain and volume cover the same tets (the host's check): one combined
    # force row per (tet, corner) instead of one per family.
    tet_fused: bool = True
    # PBD only: the rope chains (``StepConfig.distance_chain``) and the
    # Jacobi families' incidences; None on PD scenes.
    chains: ChainBatch | None = None
    jacobi: JacobiIncidence | None = None


def build_distance(
    idx: np.ndarray, positions: np.ndarray, w: np.ndarray, cap: int | None = None
) -> DistanceBatch:
    """Rest lengths from initial positions (``Constraints.cpp:49-55``)."""
    idx = np.asarray(idx, dtype=_I32).reshape(-1, 2)
    w = np.broadcast_to(np.asarray(w, dtype=_F32), (idx.shape[0],)).copy()
    rest = np.linalg.norm(
        positions[idx[:, 1]] - positions[idx[:, 0]], axis=-1
    ).astype(_F32)
    cap = cap or _round_up(idx.shape[0], 8)
    return DistanceBatch(idx=_pad2(idx, cap), rest=_pad2(rest, cap), w=_pad2(w, cap))


def build_position(
    idx: np.ndarray, positions: np.ndarray, w: np.ndarray, cap: int | None = None
) -> PositionBatch:
    """Targets captured from initial positions (``Constraints.cpp:65-74``)."""
    idx = np.asarray(idx, dtype=_I32).reshape(-1)
    w = np.broadcast_to(np.asarray(w, dtype=_F32), (idx.shape[0],)).copy()
    target = positions[idx].astype(_F32)
    cap = cap or _round_up(idx.shape[0], 8)
    return PositionBatch(
        idx=_pad2(idx, cap), target=_pad2(target, cap), w=_pad2(w, cap)
    )


def _tet_rest(idx: np.ndarray, positions: np.ndarray):
    """Rest-shape matrices shared by strain/volume tets: ``Q`` columns are the
    rest edges, inverted in float64; ``G = Qinvᵀ · W`` with
    ``W = [[-1,1,0,0],[-1,0,1,0],[-1,0,0,1]]`` (``Constraints.cpp:141-175``)."""
    p = positions[idx]  # [C,4,3]
    q = np.stack(
        [p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], axis=-1
    ).astype(np.float64)
    qinv = np.linalg.inv(q)
    west = np.array([[-1, 1, 0, 0], [-1, 0, 1, 0], [-1, 0, 0, 1]], dtype=np.float64)
    g = np.einsum("cji,jk->cik", qinv, west)
    return qinv.astype(_F32), g.astype(_F32)


def build_tets(
    idx: np.ndarray,
    positions: np.ndarray,
    w: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    cap: int | None = None,
) -> TetBatch:
    idx = np.asarray(idx, dtype=_I32).reshape(-1, 4)
    n = idx.shape[0]
    w = np.broadcast_to(np.asarray(w, dtype=_F32), (n,)).copy()
    lo = np.broadcast_to(np.asarray(lo, dtype=_F32), (n,)).copy()
    hi = np.broadcast_to(np.asarray(hi, dtype=_F32), (n,)).copy()
    if n:
        qinv, g = _tet_rest(idx, positions)
    else:
        qinv = np.zeros((0, 3, 3), _F32)
        g = np.zeros((0, 3, 4), _F32)
    cap = cap or _round_up(n, 8)
    return TetBatch(
        idx=_pad2(idx, cap),
        qinv=np.ascontiguousarray(_pad2(qinv, cap).reshape(cap, 9).T),
        g=np.ascontiguousarray(_pad2(g, cap).reshape(cap, 12).T),
        lo=_pad2(lo, cap),
        hi=_pad2(hi, cap),
        w=_pad2(w, cap),
    )


def build_bend(
    idx: np.ndarray, positions: np.ndarray, w: np.ndarray, cap: int | None = None
) -> BendBatch:
    """Rest dihedral angle from the initial configuration
    (``Constraints.cpp:368-394``)."""
    idx = np.asarray(idx, dtype=_I32).reshape(-1, 4)
    n = idx.shape[0]
    w = np.broadcast_to(np.asarray(w, dtype=_F32), (n,)).copy()
    if n:
        p = positions[idx].astype(np.float64)
        p2, p3, p4 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]
        n1 = np.cross(p2, p3)
        n2 = np.cross(p2, p4)
        n1 /= np.maximum(np.linalg.norm(n1, axis=-1, keepdims=True), 1e-30)
        n2 /= np.maximum(np.linalg.norm(n2, axis=-1, keepdims=True), 1e-30)
        d = np.clip(np.sum(n1 * n2, axis=-1), -1.0, 1.0)
        rest = np.arccos(d).astype(_F32)
    else:
        rest = np.zeros((0,), _F32)
    cap = cap or _round_up(n, 8)
    return BendBatch(idx=_pad2(idx, cap), rest_angle=_pad2(rest, cap), w=_pad2(w, cap))


def build_groups(
    groups: list[tuple[np.ndarray, np.ndarray]],  # [(node_ids, mat_coords)]
    weights: np.ndarray,
    inv_mass: np.ndarray,
    *,
    kind: str,  # "shape" | "goal"
    member_cap: int | None = None,
    group_cap: int | None = None,
) -> GroupBatch:
    """Flatten ragged shape/goal groups, group after group.

    For ``kind="shape"``, the constructor precompute of
    ``ShapeMatchingConstraint`` (``ShapeMatchingConstraint.cpp:6-48``): the
    equal-weight COM of the material coordinates, centering, and the
    mass-weighted moment matrix ``Q = Σ m·(x₀−com₀)(x₀−com₀)ᵀ``, inverted in
    float64 with ``pinv`` (planar groups have a singular moment).  For
    ``kind="goal"`` the raw initial positions are stored
    (``ShapeMatchingConstraint.cpp:124-137``).  A group may be empty."""
    num_groups = len(groups)
    weights = np.broadcast_to(np.asarray(weights, dtype=_F32), (num_groups,)).copy()
    node_idx, group_idx, mats = [], [], []
    inv_counts = np.zeros(num_groups, dtype=_F32)
    qinvs = np.tile(np.eye(3, dtype=_F32), (num_groups, 1, 1))
    counts = np.zeros(num_groups, np.int64)
    for gi, (ids, coords) in enumerate(groups):
        ids = np.asarray(ids, dtype=_I32).reshape(-1)
        coords = np.asarray(coords, dtype=np.float64).reshape(-1, 3)
        count = ids.shape[0]
        counts[gi] = count
        inv_counts[gi] = 1.0 / max(count, 1)
        if kind == "shape":
            com = coords.mean(axis=0)
            local = coords - com
            im = np.asarray(inv_mass, dtype=np.float64)[ids]
            m = np.where(im > 0, 1.0 / np.maximum(im, 1e-30), 0.0)
            q = np.einsum("mi,mj,m->ij", local, local, m)
            qinvs[gi] = np.linalg.pinv(q).astype(_F32)
            mats.append(local.astype(_F32))
        else:
            mats.append(coords.astype(_F32))
        node_idx.append(ids)
        group_idx.append(np.full(count, gi, dtype=_I32))

    node_idx = np.concatenate(node_idx) if node_idx else np.zeros(0, _I32)
    group_idx = np.concatenate(group_idx) if group_idx else np.zeros(0, _I32)
    mats = np.concatenate(mats) if mats else np.zeros((0, 3), _F32)

    m_cap = member_cap or _round_up(node_idx.shape[0], 8)
    g_cap = group_cap or max(1, num_groups)
    member_start = np.full(g_cap + 1, node_idx.shape[0], _I32)
    member_start[0] = 0
    np.cumsum(counts, out=member_start[1 : num_groups + 1])
    return GroupBatch(
        node_idx=_pad2(node_idx, m_cap),
        group_idx=_pad2(group_idx, m_cap, fill=max(0, g_cap - 1)),
        mat_coords=_pad2(mats, m_cap),
        member_mask=_pad2(np.ones(node_idx.shape[0], _F32), m_cap),
        w=_pad2(weights, g_cap),
        group_mask=_pad2(np.ones(num_groups, _F32), g_cap),
        inv_count=_pad2(inv_counts, g_cap, fill=1),
        qinv=_pad2(qinvs, g_cap),
        transforms=np.tile(np.eye(4, dtype=_F32), (g_cap, 1, 1)),
        member_start=member_start,
        max_count=int(counts.max()) if num_groups else 0,
    )


def operator_entries(num_nodes: int, tet_batches, distance: DistanceBatch | None = None):
    """The assembled ``Σ w·AᵀA`` of the live distance pairs (``+w/2`` on both
    diagonals, ``−w/2`` off: ``AᵀA = A``, ``Constraints.cpp:42-47``) and the
    live tets of ``tet_batches`` (the 16 entries of ``w·GᵀG``), coalesced in
    float64 (``np.add.at`` in entry order; ``pies_tpu/topology.py:605-646``
    is the pattern).  Returns ``(rows, cols, vals)`` sorted by row, then
    column, or None when there is no live entry."""
    rows_l, cols_l, vals_l = [], [], []
    if distance is not None:
        di, dw = np.asarray(distance.idx), np.asarray(distance.w)
        live = dw > 0
        if np.any(live):
            di, half = di[live], 0.5 * dw[live].astype(np.float64)
            for a, b, sign in ((0, 0, 1.0), (1, 1, 1.0), (0, 1, -1.0), (1, 0, -1.0)):
                rows_l.append(di[:, a])
                cols_l.append(di[:, b])
                vals_l.append(sign * half)
    for t in tet_batches:
        ti, tw = np.asarray(t.idx), np.asarray(t.w)
        live = tw > 0
        if not np.any(live):
            continue
        ti, tw = ti[live], tw[live]
        tg = np.asarray(t.g).T.reshape(-1, 3, 4)[live]
        gtg = np.einsum("cja,cjb->cab", tg, tg) * tw[:, None, None]
        for a in range(4):
            for b in range(4):
                rows_l.append(ti[:, a])
                cols_l.append(ti[:, b])
                vals_l.append(gtg[:, a, b])
    if not rows_l:
        return None
    r = np.concatenate(rows_l).astype(np.int64)
    c = np.concatenate(cols_l).astype(np.int64)
    v = np.concatenate(vals_l).astype(np.float64)
    uniq, inv = np.unique(r * num_nodes + c, return_inverse=True)
    coal = np.zeros(uniq.shape[0], np.float64)
    np.add.at(coal, inv, v)
    return uniq // num_nodes, uniq % num_nodes, coal


ELL_MAX = 64  # the widest row kept as ELL (the JAX package's bound)


def assemble_operator(num_nodes: int, tet_batches, distance: DistanceBatch | None = None):
    """:func:`operator_entries` as ``(ell, csr)``: ``ell = (nbr i32[N, m],
    coef f32[N, m])``, each row's columns ascending and padded with
    ``(0, 0.0)``, while the widest row has ``m ≤ 64`` entries (``m = 0``
    without any entry), else ``csr = (start i32[N+1], col i32[nnz], val
    f32[nnz])``; the other is None."""
    ent = operator_entries(num_nodes, tet_batches, distance)
    if ent is None:
        return (np.zeros((num_nodes, 0), _I32), np.zeros((num_nodes, 0), _F32)), None
    rr, cc, coal = ent
    deg = np.bincount(rr, minlength=num_nodes)
    m = int(deg.max())
    starts = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=starts[1:])
    if m > ELL_MAX:
        return None, (starts.astype(_I32), cc.astype(_I32), coal.astype(_F32))
    slot = np.arange(rr.shape[0], dtype=np.int64) - starts[rr]
    nbr = np.zeros((num_nodes, m), _I32)
    coef = np.zeros((num_nodes, m), _F32)
    nbr[rr, slot] = cc.astype(_I32)
    coef[rr, slot] = coal.astype(_F32)
    return (nbr, coef), None


def row_layout(topo) -> dict[str, tuple[int, int]]:
    """``family -> (first row, rows)`` of the force-row buffer that the
    local step fills and :func:`row_incidence` indexes: the families in
    ``assemble_force``'s order (``pies_tpu/solver/assembly.py:218-278``),
    each family's rows in the order of its JAX scatter's updates:
    distance ``[+half; −half]`` (``d.idx.T.reshape(-1)``), tets corner-major
    (row ``a·C + t``; the volume batch only when the tets are not fused),
    bends constraint-major (row ``4c + k``), then the shape and the goal
    members."""
    sizes = (
        ("distance", 2 * topo.distance.idx.shape[0]),
        ("strain", 4 * topo.strain.idx.shape[0]),
        ("volume", 0 if topo.tet_fused else 4 * topo.volume.idx.shape[0]),
        ("bend", 4 * topo.bend.idx.shape[0]),
        ("shape", topo.shape.node_idx.shape[0]),
        ("goal", topo.goal.node_idx.shape[0]),
    )
    out, at = {}, 0
    for name, rows in sizes:
        out[name] = (at, rows)
        at += rows
    return out


def row_incidence(num_nodes: int, *, distance, strain, volume, bend, shape, goal,
                  tet_fused: bool) -> Incidence:
    """The node → row incidence over the buffer of :func:`row_layout`, every
    row included (padding rows too, as the JAX scatters include them): each
    node's rows ascending, which is family after family and, within one, the
    order in which that family's scatter adds its updates."""
    parts = [
        np.asarray(distance.idx).T.reshape(-1),
        np.asarray(strain.idx).T.reshape(-1),
        np.zeros(0, _I32) if tet_fused else np.asarray(volume.idx).T.reshape(-1),
        np.asarray(bend.idx).reshape(-1),
        np.asarray(shape.node_idx),
        np.asarray(goal.node_idx),
    ]
    node = np.concatenate(parts).astype(np.int64)
    order = np.argsort(node, kind="stable")
    row_start = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(node, minlength=num_nodes), out=row_start[1:])
    return Incidence(
        row_start=torch.from_numpy(row_start.astype(_I32)),
        entries=torch.from_numpy(order.astype(_I32)),
        nodes=torch.from_numpy(node[order].astype(_I32)),
        cap=int(node.shape[0]),
    )


def jacobi_incidence(num_nodes: int, idx, w) -> Incidence:
    """The incidence of one PBD Jacobi family over its live rows (``w >
    0``), ``idx`` i32[C] or i32[C, k].  The entries of dead rows are left
    out: their update is +0.0, and adding it to the JAX package's sum
    changes nothing."""
    idx = np.asarray(idx).astype(np.int64)
    idx = idx.reshape(idx.shape[0], 1 if idx.ndim == 1 else idx.shape[1])
    c, k = idx.shape
    keep = np.broadcast_to((np.asarray(w) > 0)[:, None], (c, k))
    e = np.nonzero(keep.reshape(-1))[0]
    node = idx.reshape(-1)[e]
    order = np.argsort(node, kind="stable")
    row_start = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(node, minlength=num_nodes), out=row_start[1:])
    return Incidence(
        row_start=torch.from_numpy(row_start.astype(_I32)),
        entries=torch.from_numpy(e[order].astype(_I32)),
        nodes=torch.from_numpy(node[order].astype(_I32)),
        cap=int(c * k),
    )


def pbd_incidences(num_nodes: int, topo: "Topology") -> JacobiIncidence:
    """The four Jacobi families' incidences of a PBD topology."""
    return JacobiIncidence(
        position=jacobi_incidence(num_nodes, topo.position.idx, topo.position.w),
        distance=jacobi_incidence(num_nodes, np.asarray(topo.distance.idx)[:, :1],
                                  topo.distance.w),
        strain=jacobi_incidence(num_nodes, topo.strain.idx, topo.strain.w),
        bend=jacobi_incidence(num_nodes, topo.bend.idx, topo.bend.w),
    )


def corner_incidence(num_nodes: int, triangles: np.ndarray) -> Incidence:
    """The node → triangle-corner incidence of the (padded) triangles: entry
    ``e = 3·triangle + corner`` (``static_idx = triangles.reshape(-1)``,
    ``pies_tpu/collision/batches.py:104-124``), each node's entries
    ascending, the order of the JAX package's entry-list scatters.  Padding
    triangles' corners are node 0's last entries."""
    node = np.asarray(triangles).reshape(-1).astype(np.int64)
    order = np.argsort(node, kind="stable")
    row_start = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(node, minlength=num_nodes), out=row_start[1:])
    return Incidence(
        row_start=torch.from_numpy(row_start.astype(_I32)),
        entries=torch.from_numpy(order.astype(_I32)),
        nodes=torch.from_numpy(node[order].astype(_I32)),
        cap=int(node.shape[0]),
    )


def static_weights(num_nodes: int, position: PositionBatch, bend: BendBatch,
                   shape: GroupBatch, goal: GroupBatch) -> np.ndarray:
    """``Σ w`` per node of the constraints whose ``AᵀA`` is the identity:
    pins, bends (all four nodes) and shape and goal members (float64 sum),
    f32[N]; f32[1] when the scene has none of them."""
    if not (np.asarray(position.idx).shape[0] or np.asarray(bend.idx).shape[0]
            or np.asarray(shape.node_idx).shape[0] or np.asarray(goal.node_idx).shape[0]):
        return np.zeros(1, _F32)
    w = np.zeros(num_nodes, np.float64)
    np.add.at(w, np.asarray(position.idx), np.asarray(position.w, np.float64))
    bw = np.asarray(bend.w, np.float64)
    for k in range(4):
        np.add.at(w, np.asarray(bend.idx)[:, k], bw)
    for grp in (shape, goal):
        gw = np.asarray(grp.w, np.float64)[np.asarray(grp.group_idx)] * np.asarray(
            grp.member_mask)
        np.add.at(w, np.asarray(grp.node_idx), gw)
    return w.astype(_F32)


def banded_soup(strain: TetBatch, volume: TetBatch) -> bool:
    """True when the scene has live tets and every batch's live rows index
    the nodes exactly as arange: the element-major layout of a disjoint tet
    soup, which runs the tet-column path."""
    live = [np.asarray(t.idx)[np.asarray(t.w) > 0] for t in (strain, volume)]
    return any(r.size for r in live) and all(
        np.array_equal(r.reshape(-1), np.arange(r.size, dtype=np.int64)) for r in live if r.size)


def tet_band_of(num_nodes: int, strain: TetBatch, volume: TetBatch) -> np.ndarray:
    """The seven diagonals f32[7, N] of a banded soup's strain + volume
    ``Σ w·GᵀG``, summed as the JAX package sums them
    (``pies_tpu/topology.py:575-586``)."""
    band = np.zeros((7, num_nodes), dtype=_F32)
    for t in (strain, volume):
        ti, tw = np.asarray(t.idx), np.asarray(t.w)
        tg = np.asarray(t.g).T.reshape(-1, 3, 4)
        gtg = np.einsum("cja,cjb->cab", tg, tg) * tw[:, None, None]
        for a in range(4):
            for b in range(4):
                np.add.at(band[3 + b - a], ti[:, a], gtg[:, a, b])
    return band


def block_structure(num_nodes: int, distance: DistanceBatch) -> bool:
    """Whether a banded soup's system is block diagonal in 4x4 tet blocks
    (``pies_tpu/topology.py:595``)."""
    return num_nodes % 4 == 0 and np.asarray(distance.idx).shape[0] == 0


def generic_fields(num_nodes: int, *, strain, volume, position, distance, bend, shape, goal,
                   tet_fused: bool) -> dict:
    """The port's own ``Topology`` fields for the generic path: the static
    weight, the assembled operator (ELL slot-major, or CSR) and the row
    incidence.  A banded soup keeps its tets out of the operator, as the
    seven diagonals ``tet_band`` (a pure soup then has an ELL of width
    0)."""
    out = dict(static_w=static_weights(num_nodes, position, bend, shape, goal))
    banded = banded_soup(strain, volume)
    if banded:
        out["tet_band"] = tet_band_of(num_nodes, strain, volume)
    ell, csr = assemble_operator(num_nodes, () if banded else (strain, volume), distance)
    if ell is not None:
        out.update(ell_nbr=np.ascontiguousarray(ell[0].T),
                   ell_coef=np.ascontiguousarray(ell[1].T))
    else:
        out.update(csr_start=csr[0], csr_col=csr[1], csr_val=csr[2])
    out["row_inc"] = row_incidence(num_nodes, distance=distance, strain=strain, volume=volume,
                                   bend=bend, shape=shape, goal=goal, tet_fused=tet_fused)
    return out


def position_force(num_nodes: int, position: PositionBatch) -> np.ndarray:
    """``Σ w·target`` of the pins per node, accumulated in float64, f32[N, 3];
    f32[1, 3] when the scene has no pin."""
    if not np.asarray(position.idx).shape[0]:
        return np.zeros((1, 3), _F32)
    out = np.zeros((num_nodes, 3), np.float64)
    np.add.at(out, np.asarray(position.idx),
              np.asarray(position.w)[:, None].astype(np.float64)
              * np.asarray(position.target, np.float64))
    return out.astype(_F32)


def assemble_topology(
    num_nodes: int,
    *,
    strain: TetBatch,
    volume: TetBatch,
    position: PositionBatch,
    triangles: np.ndarray,
    distance: DistanceBatch,
    bend: BendBatch,
    shape: GroupBatch,
    goal: GroupBatch,
    tet_fused: bool,
) -> Topology:
    """The ported part of ``pies_tpu.topology.assemble_topology``: the
    stiffness diagonal, floor counts, ``tet_block6`` and the folded pin
    force, computed with the same host arithmetic (float64 accumulation);
    plus the port's static weight, assembled operator and row incidence
    (:func:`generic_fields`) and corner incidence.  ``tet_fused``: see
    ``Topology.tet_fused``."""
    diag = np.zeros(num_nodes, dtype=np.float64)
    # Distance AᵀA = A has 0.5 on the diagonal (Constraints.cpp:42-47).
    np.add.at(diag, distance.idx[:, 0], 0.5 * distance.w)
    np.add.at(diag, distance.idx[:, 1], 0.5 * distance.w)
    np.add.at(diag, np.asarray(position.idx), np.asarray(position.w))
    for t in (strain, volume):
        tg = np.asarray(t.g).T.reshape(-1, 3, 4)
        ata_diag = np.einsum("cji,cji->ci", tg, tg)
        for k in range(4):
            np.add.at(diag, t.idx[:, k], t.w * ata_diag[:, k])
    for k in range(4):  # A = I₄ (Constraints.cpp:390-391)
        np.add.at(diag, bend.idx[:, k], bend.w)
    for grp in (shape, goal):
        # A = B = I: +w on each member's diagonal
        # (ShapeMatchingConstraint.cpp:50-56,139-145).
        np.add.at(diag, grp.node_idx, grp.w[grp.group_idx] * grp.member_mask)

    tris = np.asarray(triangles, dtype=_I32).reshape(-1, 3)
    floor_count = np.zeros(num_nodes, dtype=_F32)
    if tris.shape[0]:
        np.add.at(floor_count, tris.reshape(-1), 1.0)

    # Banded (element-major) layout: live tet rows index nodes exactly as
    # arange.  Only then are the tets contiguous and node-disjoint.
    banded = num_nodes > 0
    for t in (strain, volume):
        live_rows = t.idx[t.w > 0]
        if live_rows.size and not np.array_equal(
            live_rows.reshape(-1), np.arange(live_rows.size, dtype=np.int64)
        ):
            banded = False
    generic = generic_fields(num_nodes, strain=strain, volume=volume, position=position,
                             distance=distance, bend=bend, shape=shape, goal=goal,
                             tet_fused=tet_fused)
    tet_block6 = None
    if banded and block_structure(num_nodes, distance):
        tet_band = generic.get("tet_band")
        if tet_band is None:  # no live tet: zero blocks
            tet_band = tet_band_of(num_nodes, strain, volume)
        # B[a][b] of block k is band[3 + b - a][4k + a].
        tet_block6 = np.stack(
            [
                tet_band[3 + b - a].reshape(-1, 4)[:, a]
                for a, b in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
            ]
        )


    tcap = _round_up(tris.shape[0], 8)
    triangles = _pad2(tris, tcap)
    return Topology(
        strain=strain,
        volume=volume,
        position=position,
        stiffness_diag=diag.astype(_F32),
        floor_count=floor_count,
        tet_block6=tet_block6,
        position_force_dense=position_force(num_nodes, position),
        triangles=triangles,
        tri_mask=_pad2(np.ones(tris.shape[0], _F32), tcap),
        **generic,
        corner_inc=corner_incidence(num_nodes, triangles) if tcap else None,
        distance=distance,
        bend=bend,
        shape=shape,
        goal=goal,
        tet_fused=tet_fused,
    )


def to_device(obj, device):
    """Copy every array leaf of a topology dataclass to a tensor on
    ``device`` (one transfer per leaf, once per scene); ints stay ints."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj,
            **{
                f.name: to_device(getattr(obj, f.name), device)
                for f in dataclasses.fields(obj)
            },
        )
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, int):
        return obj
    return torch.tensor(np.asarray(obj), device=device)
