"""Constraint topology of the ported PD paths (port of ``pies_tpu/topology.py``).

Built on the host in NumPy at scene-construction time, exactly as the JAX
package builds it, then moved to tensors once with :func:`to_device`.  Only
the batches and precomputed fields that the ported paths read are carried:
the strain and volume tet batches, position pins, the surface triangles with
their live mask (padded to a multiple of 8, as in the JAX package), the
constant stiffness diagonal, the per-node floor-contact multiplicity, the
disjoint-tet block off-diagonals, the folded pin force and, for shared-node
meshes, the assembled ELL operator.

Two fields are the port's own: the dense pin weight (the pin term of the
operator as one multiply per node) and the node → (tet, corner) incidence
(a ``collision.batches.Incidence``) that sums the tet forces per node
without float atomics.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .collision.batches import Incidence, incidence_plain

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
    # Σ w of the position pins per node; f32[1] when no pins.
    pin_w: torch.Tensor | None = None  # f32[N] or f32[1]
    # Shared-node meshes: the assembled strain+volume Σ w·GᵀG in ELL form,
    # slot-major (the transpose of the JAX package's [N, m] arrays, so
    # neighbouring nodes read neighbouring words); None otherwise.
    ell_nbr: torch.Tensor | None = None  # i32[m, N]
    ell_coef: torch.Tensor | None = None  # f32[m, N]
    # Shared-node meshes: the node → (tet, corner) incidence of the strain
    # batch (tet_incidence); None otherwise.
    tet_inc: Incidence | None = None


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


def assemble_ell(num_nodes: int, batches) -> tuple[np.ndarray | None, np.ndarray | None]:
    """The assembled ``Σ w·GᵀG`` of the live tets of ``batches`` as ELL
    ``(nbr i32[N, m], coef f32[N, m])`` (``pies_tpu/topology.py:605-646``):
    the 16 entries of every tet coalesced in float64 (``np.add.at`` in entry
    order), each row's columns ascending, rows padded with ``(0, 0.0)``.
    ``(None, None)`` when there is no live tet or ``m > 64``."""
    rows_l, cols_l, vals_l = [], [], []
    for t in batches:
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
        return None, None
    r = np.concatenate(rows_l).astype(np.int64)
    c = np.concatenate(cols_l).astype(np.int64)
    v = np.concatenate(vals_l).astype(np.float64)
    uniq, inv = np.unique(r * num_nodes + c, return_inverse=True)
    coal = np.zeros(uniq.shape[0], np.float64)
    np.add.at(coal, inv, v)
    rr, cc = uniq // num_nodes, uniq % num_nodes
    deg = np.bincount(rr, minlength=num_nodes)
    m = int(deg.max()) if deg.size else 0
    if not 0 < m <= 64:
        return None, None
    starts = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(uniq.shape[0], dtype=np.int64) - starts[rr]
    nbr = np.zeros((num_nodes, m), _I32)
    coef = np.zeros((num_nodes, m), _F32)
    nbr[rr, slot] = cc.astype(_I32)
    coef[rr, slot] = coal.astype(_F32)
    return nbr, coef


def tet_incidence(idx: np.ndarray, num_nodes: int) -> Incidence:
    """The node → (tet, corner) incidence of a tet batch ``idx`` i32[C, 4],
    every row live (padding rows included, as the JAX scatter includes
    them): entry ``k = a·C + t`` is corner a of tet t, the index of the JAX
    package's scatter ``f.at[idx.T.reshape(-1)].add(...)``, and each node's
    entries are in ascending k, the order in which that scatter adds them.
    Built with the contact incidence's builder, on CPU tensors."""
    idx = torch.tensor(np.asarray(idx, dtype=_I32))
    return incidence_plain(idx, torch.tensor([idx.shape[0]], dtype=torch.int32), num_nodes)


def pin_weights(position: PositionBatch, num_nodes: int) -> np.ndarray:
    """``Σ w`` of the position pins per node (float64 sum), f32[N]; f32[1]
    when there is no pin row."""
    idx = np.asarray(position.idx)
    if not idx.shape[0]:
        return np.zeros(1, _F32)
    w = np.zeros(num_nodes, np.float64)
    np.add.at(w, idx, np.asarray(position.w, np.float64))
    return w.astype(_F32)


def assemble_topology(
    num_nodes: int,
    *,
    strain: TetBatch,
    volume: TetBatch,
    position: PositionBatch,
    triangles: np.ndarray,
) -> Topology:
    """The ported part of ``pies_tpu.topology.assemble_topology``: the
    stiffness diagonal, floor counts, ``tet_block6``, the folded pin force
    and, when the tets are not banded, the ELL operator, computed with the
    same host arithmetic (float64 accumulation); plus the port's pin weight
    and tet incidence."""
    diag = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(diag, np.asarray(position.idx), np.asarray(position.w))
    for t in (strain, volume):
        tg = np.asarray(t.g).T.reshape(-1, 3, 4)
        ata_diag = np.einsum("cji,cji->ci", tg, tg)
        for k in range(4):
            np.add.at(diag, t.idx[:, k], t.w * ata_diag[:, k])

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
    tet_block6 = None
    if banded and num_nodes % 4 == 0:
        tet_band = np.zeros((7, num_nodes), dtype=_F32)
        for t in (strain, volume):
            tg = np.asarray(t.g).T.reshape(-1, 3, 4)
            gtg = np.einsum("cja,cjb->cab", tg, tg) * t.w[:, None, None]
            for a in range(4):
                for b in range(4):
                    np.add.at(tet_band[3 + b - a], t.idx[:, a], gtg[:, a, b])
        # B[a][b] of block k is band[3 + b - a][4k + a].
        tet_block6 = np.stack(
            [
                tet_band[3 + b - a].reshape(-1, 4)[:, a]
                for a, b in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
            ]
        )

    ell_nbr = ell_coef = tet_inc = None
    if not banded:
        nbr, coef = assemble_ell(num_nodes, (strain, volume))
        if nbr is not None:
            ell_nbr, ell_coef = np.ascontiguousarray(nbr.T), np.ascontiguousarray(coef.T)
        tet_inc = tet_incidence(strain.idx, num_nodes)

    if np.asarray(position.idx).shape[0]:
        pos_force = np.zeros((num_nodes, 3), np.float64)
        np.add.at(
            pos_force,
            np.asarray(position.idx),
            np.asarray(position.w)[:, None].astype(np.float64)
            * np.asarray(position.target, np.float64),
        )
        pos_force = pos_force.astype(_F32)
    else:
        pos_force = np.zeros((1, 3), _F32)

    tcap = _round_up(tris.shape[0], 8)
    return Topology(
        strain=strain,
        volume=volume,
        position=position,
        stiffness_diag=diag.astype(_F32),
        floor_count=floor_count,
        tet_block6=tet_block6,
        position_force_dense=pos_force,
        triangles=_pad2(tris, tcap),
        tri_mask=_pad2(np.ones(tris.shape[0], _F32), tcap),
        pin_w=pin_weights(position, num_nodes),
        ell_nbr=ell_nbr,
        ell_coef=ell_coef,
        tet_inc=tet_inc,
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
