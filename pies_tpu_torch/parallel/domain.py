"""Spatial domain decomposition of one scene, on one card or over ranks
(port of ``pies_tpu/parallel/domain.py``, ROADMAP items 11a and 11b).

The JAX package sorts the nodes along the scene's longest axis, cuts them
into D slabs of L owned nodes, gives each slab a view of V = L + 2B slots
(B halo copies of each neighbour's boundary band) and runs the PD substep
under ``shard_map``, one slab per device: halo refresh and halo reduce are
``ppermute``s, the CG's dot products ``psum``s over the owned nodes.  Here
the D slabs sit on one card, and the same algorithm runs as launches:

* the host partitioner (:func:`partition_domain`) is a NumPy copy of the
  JAX one, array for array; its per-slab batches (view-local indices) are
  then laid end to end as one flat scene of D·V slots, slab s's indices
  shifted by s·V: a block-diagonal topology, with the port's own derived
  fields (the assembled operator, the row incidence, the groups' runs)
  built over it, so that T9-T13, T23, T26 and T27 run on it unchanged;
* kernel T30 (``csrc/halo.cu``, :mod:`.halo`) moves values between the
  owned f32[D, L, k] and the views f32[D, V, k]: refresh, reduce, the
  count-averaged applies of the stabilization and friction accumulators,
  and the gather of the slabs' contact lists into the flat scene;
* T3 and T4 take the owned nodes as one flat scene of D·L nodes with the
  owned attributes (the substep's head and tail); T4's latch is the
  domain's single latch, so one slab's NaN or overflow latches every slab,
  as the JAX package's ``psum`` of the failures does;
* the CG (``assembly.pcg_solve`` with a halo-exchanged operator: refresh,
  T10 over the views, T30's reduce with the ``p·Ap`` partials over the
  owned nodes only) runs T11's stages over the D·L owned nodes, so the dot
  products and the ``rtol`` exit are global; always Jacobi on the owned
  diagonal, as the JAX domain;
* detection stays per slab (in one shared grid, a slab's triangles would
  meet its neighbour's halo copies of its own nodes): T16/T17, T25 and T20
  run on each slab's view with its emit mask, each slab with a buffer of
  its own; T30 then gathers the lists into the flat scene;
* T8 and T27's friction run in their accumulate-only modes over the views,
  and T30 sums the accumulators across the halo before it averages.

Configuration: the packed-body and super-body detections assume the
original numbering, so the tick always runs the per-triangle branches, on
the dense floor (``pies_tpu/parallel/domain.py:990-1000``).  Floor-active
nodes snap only in the stabilization passes, none without them, as in the
JAX domain and both packages' single scenes.  Where the JAX domain keeps
stepping a latched scene, the port freezes it, as both packages' single
scenes do (ROADMAP: faults known in the reference).

Over R ranks (ROADMAP item 11b, a :class:`.ranks.Mesh`): rank r holds the
slabs ``[r·D/R, (r+1)·D/R)`` (:func:`shard_domain`; every rank partitions
the same scene and keeps its slabs, so no host dict is broadcast) and
steps them through the same substep.  T30 takes the rank's two outer
bands, which :class:`.ranks.Transport` exchanges with the neighbouring
ranks before each refresh and reduce (the ``ppermute``s of
``domain.py:581-609``); T11 writes the rank's block partials into its
slice of buffers gathered in rank order before each total (the ``psum``'d
dots of ``:612-656``), so every rank leaves the CG on the same trip; after
every substep an ``all_reduce(MAX)`` of the latch words gives every rank
the domain's one latch (the ``psum`` of ``:971-973``), which the next
tick's gates read.  Detection stays per slab inside the rank.  Counters
count the rank's slabs and are summed across ranks when read
(:func:`read_counters`).  The tick runs on CUDA unless the state lives on
the CPU, where every wrapper takes its plain twin.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from ..collision import broadphase
from ..collision.batches import CollisionSet, floor_plane
from ..options import PhysicsParams, StepConfig
from ..scene.contact_piles import SUPER_OFF
from ..solver import assembly, pd
from ..state import NodePairCache, SolverState, park_positions, stack_members
from ..topology import (
    BendBatch,
    DistanceBatch,
    GroupBatch,
    PositionBatch,
    TetBatch,
    Topology,
    generic_fields,
    position_force,
    to_device,
)
from . import halo
from .ranks import Mesh, Transport

_F32 = np.float32
_I32 = np.int32


def _round_up(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


@dataclass(frozen=True)
class DomainMeta:
    """Static partition geometry."""

    n_slabs: int
    block: int  # L: owned nodes per slab
    halo: int  # B: halo band width (nodes)

    @property
    def view(self) -> int:
        return self.block + 2 * self.halo


@dataclass
class DomainState:
    """Per-slab dynamic state: owned nodes f32[D, L, 3], the shape groups'
    rotations f32[D, G, 4] and the domain's latch i32[2] (the two slots of
    ``state.py``), one for all slabs."""

    positions: torch.Tensor
    prev_positions: torch.Tensor
    velocities: torch.Tensor
    shape_quats: torch.Tensor
    sim_failed: torch.Tensor

    def failed_slabs(self) -> np.ndarray:
        """bool[D]: the JAX package's per-slab latch (equal on every slab)."""
        return np.full(self.positions.shape[0], bool(self.sim_failed.any()))


@dataclass
class DomainStatic:
    """Per-slab static data: the JAX package's node-attribute views f32[D,
    V], owned stiffness diagonal f32[D, L] and triangle views (view-local
    indices, i32[D, Tv, 3], their masks and the owned-triangle emit mask
    f32[D, Tv]); the port's flat view topology (D·V nodes), the owned
    attributes as one flat scene of D·L nodes and each slab's owned-node
    emit mask f32[D, V] (node-node pairs)."""

    inv_mass_view: torch.Tensor
    mass_view: torch.Tensor
    node_mask_view: torch.Tensor
    radius_view: torch.Tensor
    mass_own_view: torch.Tensor
    stiffness_diag_own: torch.Tensor
    triangles: torch.Tensor
    tri_mask: torch.Tensor
    tri_emit_mask: torch.Tensor
    topo: Topology
    own: SimpleNamespace = field(repr=False)  # inv_mass, mass, node_mask, floor_count f32[D·L]
    node_emit: torch.Tensor = field(repr=False)


@dataclass
class Domain:
    """Partition result: geometry, tensors, the node permutation (new →
    old, old → new), the shape groups' (slab, slot) map and the host arrays
    (``host``: NumPy, keyed by the JAX ``Domain``'s field paths)."""

    meta: DomainMeta
    state: DomainState
    static: DomainStatic
    perm: np.ndarray
    inv_perm: np.ndarray
    group_slab: np.ndarray
    host: dict = field(repr=False)


# ---------------------------------------------------------------------------
# host-side partitioner (pies_tpu/parallel/domain.py:152-573)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _slab_of(idx_new: np.ndarray, w: np.ndarray, block: int) -> np.ndarray:
    """Slab owning each constraint: the slab of its lowest (live) node."""
    lo = idx_new.min(axis=-1) if idx_new.ndim > 1 else idx_new
    return np.where(np.asarray(w) > 0, lo // block, 0).astype(_I32)


def _needed_halo(idx_new: np.ndarray, w: np.ndarray, block: int) -> int:
    if idx_new.size == 0:
        return 0
    idx2 = idx_new.reshape(idx_new.shape[0], -1)
    live = np.asarray(w) > 0
    if not np.any(live):
        return 0
    slab = idx2.min(axis=-1) // block
    over = idx2.max(axis=-1) - ((slab + 1) * block - 1)
    return int(max(0, over[live].max()))


def _stack_rows(rows_per_slab: list[np.ndarray], cap: int, fill=0) -> np.ndarray:
    d = len(rows_per_slab)
    out = np.full((d, cap) + rows_per_slab[0].shape[1:], fill, dtype=rows_per_slab[0].dtype)
    for s, r in enumerate(rows_per_slab):
        out[s, : r.shape[0]] = r
    return out


def _own_window_mask(meta: DomainMeta) -> np.ndarray:
    m = np.zeros(meta.view, _F32)
    m[meta.halo: meta.halo + meta.block] = 1.0
    return m[None, :]


GROUP_FIELDS = ("node_idx", "group_idx", "mat_coords", "member_mask", "w", "group_mask",
                "inv_count", "qinv", "transforms")
BATCH_FIELDS = dict(distance=("idx", "rest", "w"), position=("idx", "target", "w"),
                    strain=("idx", "qinv", "g", "lo", "hi", "w"),
                    volume=("idx", "qinv", "g", "lo", "hi", "w"),
                    bend=("idx", "rest_angle", "w"), shape=GROUP_FIELDS, goal=GROUP_FIELDS)


def host_keys() -> list[str]:
    """The host arrays a ``Domain`` carries, by the JAX ``Domain``'s field
    paths (``convert.domain_from_numpy`` reads the JAX one by them)."""
    keys = [f"state.{f}" for f in ("positions", "prev_positions", "velocities", "shape_quats",
                                   "sim_failed")]
    keys += [f"static.{f}" for f in ("inv_mass_view", "mass_view", "node_mask_view",
                                     "radius_view", "mass_own_view", "stiffness_diag_own",
                                     "tri_emit_mask")]
    keys += [f"static.topo.{b}.{f}" for b, fs in BATCH_FIELDS.items() for f in fs]
    keys += ["static.topo.triangles", "static.topo.tri_mask", "static.topo.floor_count",
             "perm", "inv_perm", "group_slab"]
    return keys


def partition_domain(state: SolverState, topo: Topology, n_slabs: int, halo: int | None = None,
                     sort_axis: int | None = None, collision_margin: float = 0.0,
                     mesh: Mesh | None = None) -> Domain:
    """Partition a scene into ``n_slabs`` spatial slabs
    (``pies_tpu/parallel/domain.py:181``).

    Renumbers nodes by a stable sort along the longest scene axis (dead
    nodes last), sizes the halo band from the constraint index spreads and
    from ``collision_margin`` (world units: collision threshold + the
    largest swept triangle extent + per-substep motion; 0 for constraint
    locality only) unless ``halo`` is given, and emits per-slab constraint
    batches in view-local indices.  Raises ``ValueError`` when a given halo
    is narrower than the constraints need, or when the halo exceeds the
    block (too many slabs).  The tensors go to the state's device; with
    ``mesh``, only this rank's slabs, to the mesh's device
    (:func:`shard_host`)."""
    pos = _np(state.positions).astype(_F32)
    mask = _np(state.node_mask).astype(_F32)
    live = mask > 0

    if sort_axis is None:
        lp = pos[live]
        ext = lp.max(axis=0) - lp.min(axis=0) if lp.size else np.ones(3)
        sort_axis = int(np.argmax(ext))

    key = np.where(live, pos[:, sort_axis], np.float32(np.inf))
    perm = np.argsort(key, kind="stable").astype(_I32)  # new -> old

    n_cap = pos.shape[0]
    block = _round_up(-(-n_cap // n_slabs), 8)
    total = block * n_slabs
    extra = total - n_cap  # extra parked padding nodes

    inv_perm = np.empty(total, dtype=_I32)
    inv_perm[perm] = np.arange(n_cap, dtype=_I32)
    inv_perm[n_cap:] = np.arange(n_cap, total, dtype=_I32)

    def node_attr(a: np.ndarray, pad_value) -> np.ndarray:
        a = np.asarray(a)
        return np.concatenate([a[perm], np.full((extra,) + a.shape[1:], pad_value, a.dtype)])

    pos_n = node_attr(pos, 0.0)
    if extra:
        pos_n[n_cap:] = park_positions(extra, offset=n_cap)
    prev_n = node_attr(_np(state.prev_positions).astype(_F32), 0.0)
    if extra:
        prev_n[n_cap:] = pos_n[n_cap:]
    vel_n = node_attr(_np(state.velocities).astype(_F32), 0.0)
    im_n = node_attr(_np(state.inv_mass).astype(_F32), 0.0)
    m_n = node_attr(_np(state.mass).astype(_F32), 1.0)
    mask_n = node_attr(mask, 0.0)

    def remap(idx):
        return inv_perm[np.asarray(_np(idx), _I32)]

    d_idx, p_idx = remap(topo.distance.idx), remap(topo.position.idx)
    s_idx, v_idx = remap(topo.strain.idx), remap(topo.volume.idx)
    b_idx, tri_idx = remap(topo.bend.idx), remap(topo.triangles)

    need = 0
    for idx, w in ((d_idx, topo.distance.w), (s_idx, topo.strain.w), (v_idx, topo.volume.w),
                   (b_idx, topo.bend.w)):
        need = max(need, _needed_halo(idx, _np(w), block))

    def group_spread(grp: GroupBatch):
        ni = remap(grp.node_idx)
        gi = _np(grp.group_idx)
        mm = _np(grp.member_mask) > 0
        worst = 0
        for g in range(grp.num_groups):
            sel = mm & (gi == g)
            if not np.any(sel):
                continue
            lo, hi = ni[sel].min(), ni[sel].max()
            worst = max(worst, int(hi - (lo // block + 1) * block + 1))
        return max(0, worst)

    need = max(need, group_spread(topo.shape), group_spread(topo.goal))
    tri_mask = _np(topo.tri_mask)
    tri_live = tri_mask > 0
    if np.any(tri_live):
        need = max(need, _needed_halo(tri_idx, tri_mask, block))
    if collision_margin > 0.0 and np.any(live):
        key_sorted = np.sort(pos[live][:, sort_axis])
        for s in range(1, n_slabs):
            c = key_sorted[min(s * block, key_sorted.shape[0] - 1)]
            inside = np.sum((key_sorted >= c - collision_margin)
                            & (key_sorted <= c + collision_margin))
            need = max(need, int(inside))
    if halo is None:
        halo = _round_up(max(need, 8), 8)
    elif need > halo:
        raise ValueError(f"halo {halo} too small: constraints span {need} nodes past "
                         f"their slab boundary (block={block})")
    if halo > block:
        raise ValueError(f"halo {halo} exceeds block {block}: too many slabs for this "
                         "scene's constraint locality")
    meta = DomainMeta(n_slabs=n_slabs, block=block, halo=halo)
    view = meta.view
    host: dict[str, np.ndarray] = {}

    def localize(idx_new: np.ndarray, slab: np.ndarray) -> np.ndarray:
        loc = idx_new - slab.reshape((-1,) + (1,) * (idx_new.ndim - 1)) * block + halo
        return np.clip(loc, 0, view - 1).astype(_I32)

    def split(idx_new, w, *extras):
        """One batch's rows by slab: per slab (local idx, w, *extras)."""
        w = _np(w)
        slab = _slab_of(idx_new, w, block)
        rows = []
        for s in range(n_slabs):
            sel = (slab == s) & (w > 0)
            loc = localize(idx_new[sel], slab[sel])
            rows.append((loc, w[sel]) + tuple(_np(e)[sel] for e in extras))
        return rows

    def stack_batch(name, rows, fields):
        cap = _round_up(max((r[0].shape[0] for r in rows), default=0), 8)
        for c, f in enumerate(fields):
            host[f"static.topo.{name}.{f}"] = _stack_rows([r[c] for r in rows], cap, 0)

    rows = split(d_idx, topo.distance.w, topo.distance.rest)
    stack_batch("distance", rows, ("idx", "w", "rest"))
    rows = split(p_idx.reshape(-1, 1), topo.position.w, topo.position.target)
    stack_batch("position", rows, ("idx", "w", "target"))
    host["static.topo.position.idx"] = host["static.topo.position.idx"][..., 0]
    for name, idx_new in (("strain", s_idx), ("volume", v_idx)):
        t = getattr(topo, name)
        rows = split(idx_new, t.w, _np(t.qinv).T, _np(t.g).T, t.lo, t.hi)
        stack_batch(name, rows, ("idx", "w", "qinv", "g", "lo", "hi"))
        for f in ("qinv", "g"):
            host[f"static.topo.{name}.{f}"] = np.ascontiguousarray(
                np.swapaxes(host[f"static.topo.{name}.{f}"], 1, 2))
    rows = split(b_idx, topo.bend.w, topo.bend.rest_angle)
    stack_batch("bend", rows, ("idx", "w", "rest_angle"))

    def split_groups(name, grp: GroupBatch):
        """Each group to the slab of its lowest member."""
        ni = remap(grp.node_idx)
        gi = _np(grp.group_idx)
        mm = _np(grp.member_mask) > 0
        g_map = np.full((grp.num_groups, 2), -1, _I32)
        members: list[list] = [[] for _ in range(n_slabs)]
        groups: list[list] = [[] for _ in range(n_slabs)]
        gmask = _np(grp.group_mask)
        coords = _np(grp.mat_coords)
        for g in range(grp.num_groups):
            sel = mm & (gi == g)
            if not (gmask[g] > 0 and np.any(sel)):
                continue
            s = int(ni[sel].min() // block)
            slot = len(groups[s])
            g_map[g] = (s, slot)
            groups[s].append(g)
            loc = ni[sel] - s * block + halo
            members[s].append((loc.astype(_I32), np.full(loc.shape[0], slot, _I32),
                               coords[sel]))
        m_cap = _round_up(max((sum(m[0].shape[0] for m in ms) for ms in members), default=0),
                          8)
        g_cap = max(1, max((len(g) for g in groups), default=1))
        out = dict(node_idx=np.zeros((n_slabs, m_cap), _I32),
                   group_idx=np.full((n_slabs, m_cap), g_cap - 1, _I32),
                   mat_coords=np.zeros((n_slabs, m_cap, 3), _F32),
                   member_mask=np.zeros((n_slabs, m_cap), _F32),
                   w=np.zeros((n_slabs, g_cap), _F32), group_mask=np.zeros((n_slabs, g_cap), _F32),
                   inv_count=np.ones((n_slabs, g_cap), _F32),
                   qinv=np.tile(np.eye(3, dtype=_F32), (n_slabs, g_cap, 1, 1)),
                   transforms=np.tile(np.eye(4, dtype=_F32), (n_slabs, g_cap, 1, 1)))
        w, inv_count = _np(grp.w), _np(grp.inv_count)
        qinv, transforms = _np(grp.qinv), _np(grp.transforms)
        for s in range(n_slabs):
            off = 0
            for slot, g in enumerate(groups[s]):
                loc, gl, mc = members[s][slot]
                cnt = loc.shape[0]
                out["node_idx"][s, off: off + cnt] = loc
                out["group_idx"][s, off: off + cnt] = gl
                out["mat_coords"][s, off: off + cnt] = mc
                out["member_mask"][s, off: off + cnt] = 1.0
                off += cnt
                out["w"][s, slot] = w[g]
                out["group_mask"][s, slot] = 1.0
                out["inv_count"][s, slot] = inv_count[g]
                out["qinv"][s, slot] = qinv[g]
                out["transforms"][s, slot] = transforms[g]
        for f, a in out.items():
            host[f"static.topo.{name}.{f}"] = a
        return g_map

    shape_map = split_groups("shape", topo.shape)
    split_groups("goal", topo.goal)

    # Floor-contact multiplicity per owned node (owner-local by nature).
    corners = tri_idx.reshape(-1)
    cm = np.repeat(tri_mask, 3) > 0
    floor_count = np.zeros(total, _F32)
    np.add.at(floor_count, corners[cm], 1.0)

    # Per-slab triangle views: every live triangle inside [s·L − B, s·L + L
    # + B); the owned (emitting) ones have their lowest node in the slab.
    tri_rows, emit_rows = [], []
    if np.any(tri_live):
        tmin, tmax = tri_idx.min(axis=1), tri_idx.max(axis=1)
        for s in range(n_slabs):
            inview = tri_live & (tmin >= s * block - halo) & (tmax < s * block + block + halo)
            owned = inview & (tmin >= s * block) & (tmin < (s + 1) * block)
            tri_rows.append((tri_idx[inview] - s * block + halo).astype(_I32))
            emit_rows.append(owned[inview].astype(_F32))
    else:
        tri_rows = [np.zeros((0, 3), _I32)] * n_slabs
        emit_rows = [np.zeros((0,), _F32)] * n_slabs
    tv_cap = (_round_up(max(r.shape[0] for r in tri_rows), 8)
              if any(r.shape[0] for r in tri_rows) else 0)
    if tv_cap:
        host["static.topo.triangles"] = _stack_rows([r.reshape(-1, 3) for r in tri_rows], tv_cap)
        host["static.topo.tri_mask"] = _stack_rows(
            [np.ones(r.shape[0], _F32) for r in tri_rows], tv_cap)
        host["static.tri_emit_mask"] = _stack_rows(emit_rows, tv_cap)
    else:
        host["static.topo.triangles"] = np.zeros((n_slabs, 0, 3), _I32)
        host["static.topo.tri_mask"] = np.zeros((n_slabs, 0), _F32)
        host["static.tri_emit_mask"] = np.zeros((n_slabs, 0), _F32)

    def window(a: np.ndarray, pad_value=0.0) -> np.ndarray:
        pad = np.full((halo,) + a.shape[1:], pad_value, a.dtype)
        padded = np.concatenate([pad, a, pad])
        return np.stack([padded[s * block: s * block + view] for s in range(n_slabs)])

    stiff = np.concatenate([_np(topo.stiffness_diag)[perm], np.zeros(extra, _F32)])
    host["static.topo.floor_count"] = window(floor_count) * _own_window_mask(meta)

    quats = _np(state.shape_quats).astype(_F32)
    g_cap_s = host["static.topo.shape.w"].shape[1]
    quats_s = np.zeros((n_slabs, g_cap_s, 4), _F32)
    quats_s[..., 0] = 1.0
    for g, (s, slot) in enumerate(shape_map):
        if s >= 0 and g < quats.shape[0]:
            quats_s[s, slot] = quats[g]

    host.update({
        "state.positions": pos_n.reshape(n_slabs, block, 3),
        "state.prev_positions": prev_n.reshape(n_slabs, block, 3),
        "state.velocities": vel_n.reshape(n_slabs, block, 3),
        "state.shape_quats": quats_s,
        "state.sim_failed": np.zeros(n_slabs, bool),
        "static.inv_mass_view": window(im_n),
        "static.mass_view": window(m_n, pad_value=1.0),
        "static.node_mask_view": window(mask_n),
        "static.radius_view": window(node_attr(_np(state.radius).astype(_F32), 0.0)),
        "static.mass_own_view": window(m_n) * _own_window_mask(meta),
        "static.stiffness_diag_own": stiff.reshape(n_slabs, block),
        "perm": perm,
        "inv_perm": inv_perm[:n_cap],
        "group_slab": shape_map,
    })
    if mesh is not None:
        return shard_host(host, meta, mesh)
    return domain_from_host(host, meta, state.positions.device)


# ---------------------------------------------------------------------------
# the port's tensors: the flat view topology and the owned attributes


def _flat_groups(h: dict, name: str, d: int, v: int) -> GroupBatch:
    """The slabs' groups as one batch of the flat scene: group s·G + slot,
    members node + s·V, the real members first (slab after slab, group
    after group: consecutive runs), padding members after them."""
    g = {f: h[f"static.topo.{name}.{f}"] for f in GROUP_FIELDS}
    d, m_cap = g["node_idx"].shape
    g_cap = g["w"].shape[1]
    real = g["member_mask"] > 0
    slab = np.repeat(np.arange(d), m_cap).reshape(d, m_cap)
    node = (g["node_idx"] + slab * v)[real]
    grp = (g["group_idx"] + slab * g_cap)[real]
    order = np.argsort(grp, kind="stable")
    node, grp = node[order], grp[order]
    coords = g["mat_coords"][real][order]
    n_real, cap = node.shape[0], d * m_cap
    counts = np.bincount(grp, minlength=d * g_cap)
    start = np.full(d * g_cap + 1, n_real, _I32)
    start[0] = 0
    np.cumsum(counts, out=start[1:])
    pad = lambda a, fill: np.concatenate(  # noqa: E731
        [a, np.full((cap - n_real,) + a.shape[1:], fill, a.dtype)])
    return GroupBatch(
        node_idx=pad(node.astype(_I32), 0),
        group_idx=pad(grp.astype(_I32), d * g_cap - 1),
        mat_coords=pad(coords.astype(_F32), 0.0),
        member_mask=pad(np.ones(n_real, _F32), 0.0),
        w=g["w"].reshape(-1), group_mask=g["group_mask"].reshape(-1),
        inv_count=g["inv_count"].reshape(-1), qinv=g["qinv"].reshape(-1, 3, 3),
        transforms=g["transforms"].reshape(-1, 4, 4), member_start=start,
        max_count=int(counts.max()) if counts.size else 0)


def flat_topology(h: dict, meta: DomainMeta) -> Topology:
    """The flat view topology (NumPy leaves): the slabs' batches end to end,
    slab s's view-local indices shifted by s·V, their live rows only, the
    port's derived fields
    built over the D·V nodes (the static weight, the assembled operator,
    the row incidence), the stiffness diagonal on the owned slots (the
    contacts' setups add their diagonals to it), the owned floor counts;
    no block layout, no corner incidence (the domain's floor is dense)."""
    d, v, b, l = meta.n_slabs, meta.view, meta.halo, meta.block
    t = lambda name, f: h[f"static.topo.{name}.{f}"]  # noqa: E731
    shift = lambda idx: (idx + (np.arange(d) * v).reshape(  # noqa: E731
        (d,) + (1,) * (idx.ndim - 1))).reshape((-1,) + idx.shape[2:]).astype(_I32)

    def live(name):
        """The batch's live rows over all slabs, padded to a multiple of 8
        (a slab's padding rows, w = 0, would all sit on its view's first
        slot: one node with tens of thousands of force rows)."""
        keep = np.nonzero(t(name, "w").reshape(-1) > 0)[0]
        cap = -(-keep.shape[0] // 8) * 8
        rows = np.zeros(cap, np.int64)
        rows[:keep.shape[0]] = keep
        return rows, keep.shape[0]

    def rows_of(a, rows, n):
        out = a[rows]
        out[n:] = 0
        return np.ascontiguousarray(out)

    def tets(name):
        rows, n = live(name)
        return TetBatch(idx=rows_of(shift(t(name, "idx")), rows, n),
                        qinv=rows_of(np.concatenate(list(t(name, "qinv")), axis=1).T, rows, n).T
                        .copy(),
                        g=rows_of(np.concatenate(list(t(name, "g")), axis=1).T, rows, n).T.copy(),
                        lo=rows_of(t(name, "lo").reshape(-1), rows, n),
                        hi=rows_of(t(name, "hi").reshape(-1), rows, n),
                        w=rows_of(t(name, "w").reshape(-1), rows, n))

    strain, volume = tets("strain"), tets("volume")
    rows, n = live("position")
    position = PositionBatch(idx=rows_of(shift(t("position", "idx")), rows, n),
                             target=rows_of(t("position", "target").reshape(-1, 3), rows, n),
                             w=rows_of(t("position", "w").reshape(-1), rows, n))
    rows, n = live("distance")
    distance = DistanceBatch(idx=rows_of(shift(t("distance", "idx")), rows, n),
                             rest=rows_of(t("distance", "rest").reshape(-1), rows, n),
                             w=rows_of(t("distance", "w").reshape(-1), rows, n))
    rows, n = live("bend")
    bend = BendBatch(idx=rows_of(shift(t("bend", "idx")), rows, n),
                     rest_angle=rows_of(t("bend", "rest_angle").reshape(-1), rows, n),
                     w=rows_of(t("bend", "w").reshape(-1), rows, n))
    shape, goal = _flat_groups(h, "shape", d, v), _flat_groups(h, "goal", d, v)
    n = d * v
    tet_fused = (strain.idx.shape == volume.idx.shape and np.array_equal(strain.idx, volume.idx)
                 and np.array_equal(strain.w > 0, volume.w > 0))
    stiff = np.zeros((d, v), _F32)
    stiff[:, b: b + l] = h["static.stiffness_diag_own"]
    tris = h["static.topo.triangles"]
    return Topology(
        strain=strain, volume=volume, position=position,
        stiffness_diag=stiff.reshape(-1),
        floor_count=h["static.topo.floor_count"].reshape(-1).astype(_F32),
        tet_block6=None, position_force_dense=position_force(n, position),
        triangles=shift(tris) if tris.shape[1] else np.zeros((0, 3), _I32),
        tri_mask=h["static.topo.tri_mask"].reshape(-1),
        **generic_fields(n, strain=strain, volume=volume, position=position, distance=distance,
                         bend=bend, shape=shape, goal=goal, tet_fused=tet_fused),
        distance=distance, bend=bend, shape=shape, goal=goal, tet_fused=tet_fused)


def domain_from_host(h: dict, meta: DomainMeta, device) -> Domain:
    """The ``Domain`` of the host arrays ``h`` (keys of :func:`host_keys`)
    on ``device``."""
    device = torch.device(device)
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.array(a, copy=True)).to(device, dt)  # (a copy: the tick writes the state)
    d, l, b = meta.n_slabs, meta.block, meta.halo
    own = lambda key: t(h[key][:, b: b + l].reshape(-1))  # noqa: E731
    failed = torch.zeros(2, dtype=torch.int32, device=device)
    failed[0] = int(np.any(h["state.sim_failed"]))
    state = DomainState(positions=t(h["state.positions"]),
                        prev_positions=t(h["state.prev_positions"]),
                        velocities=t(h["state.velocities"]), shape_quats=t(h["state.shape_quats"]),
                        sim_failed=failed)
    owned = np.zeros((1, meta.view), _F32)
    owned[:, b: b + l] = 1.0
    static = DomainStatic(
        inv_mass_view=t(h["static.inv_mass_view"]), mass_view=t(h["static.mass_view"]),
        node_mask_view=t(h["static.node_mask_view"]), radius_view=t(h["static.radius_view"]),
        mass_own_view=t(h["static.mass_own_view"]),
        stiffness_diag_own=t(h["static.stiffness_diag_own"]),
        triangles=t(h["static.topo.triangles"], torch.int32),
        tri_mask=t(h["static.topo.tri_mask"]), tri_emit_mask=t(h["static.tri_emit_mask"]),
        topo=to_device(flat_topology(h, meta), device),
        own=SimpleNamespace(inv_mass=own("static.inv_mass_view"),
                            mass=own("static.mass_own_view"),
                            node_mask=own("static.node_mask_view"),
                            floor_count=own("static.topo.floor_count"),
                            stiffness_diag=t(h["static.stiffness_diag_own"].reshape(-1)),
                            corner_inc=None),
        node_emit=t(owned * h["static.node_mask_view"]))
    return Domain(meta=meta, state=state, static=static, perm=np.asarray(h["perm"]),
                  inv_perm=np.asarray(h["inv_perm"]), group_slab=np.asarray(h["group_slab"]),
                  host=h)


GLOBAL_KEYS = ("perm", "inv_perm", "group_slab")  # the host arrays with no slab axis


def shard_host(host: dict, meta: DomainMeta, mesh: Mesh) -> Domain:
    """This rank's ``Domain`` of the partition ``host`` (keys of
    :func:`host_keys`) of ``meta.n_slabs`` slabs: the slabs ``[r·D/R,
    (r+1)·D/R)`` on the mesh's device, with the flat view topology of those
    slabs only.  Its ``meta`` stays the whole domain's; raises unless R
    divides D."""
    mine = mesh.share(meta.n_slabs, "slabs")
    local = {k: a if k in GLOBAL_KEYS else a[mine] for k, a in host.items()}
    dom = domain_from_host(local, local_meta(meta, mesh), mesh.device)
    dom.meta, dom.host = meta, host
    return dom


def shard_domain(domain: Domain, mesh: Mesh) -> Domain:
    """This rank's slabs of a whole ``domain`` (:func:`shard_host` of its
    host arrays)."""
    return shard_host(domain.host, domain.meta, mesh)


def local_meta(meta: DomainMeta, mesh: Mesh | None) -> DomainMeta:
    """The geometry of one rank's slabs (``meta`` without a mesh)."""
    if mesh is None:
        return meta
    mine = mesh.share(meta.n_slabs, "slabs")
    return dataclasses.replace(meta, n_slabs=mine.stop - mine.start)


def gather_positions(domain: Domain, dstate: DomainState, mesh: Mesh | None = None) -> np.ndarray:
    """Owned positions back in the original node order (the capacity's);
    with ``mesh`` every rank's slabs, all-gathered in rank order (every rank
    gets them all)."""
    pos = dstate.positions
    if mesh is not None:
        pos = Transport(mesh).gather(pos.contiguous())
    flat = pos.detach().cpu().numpy().reshape(-1, 3)
    return flat[domain.inv_perm]


def read_counters(counters: dict, mesh: Mesh | None = None) -> dict[str, int]:
    """``pd.new_counters``' values as ints, summed over the ranks with
    ``mesh`` (each rank counts its own slabs)."""
    names = list(counters)
    vals = torch.stack([counters[k].reshape(()) for k in names])
    if mesh is not None:
        Transport(mesh).all_reduce_(vals)
    return dict(zip(names, (int(v) for v in vals.tolist())))


# ---------------------------------------------------------------------------
# the tick


def domain_config(config: StepConfig) -> StepConfig:
    """The configuration the domain tick runs (``domain.py:990-1000``): the
    per-triangle detection branches (no packed bodies, no super-body
    layout: the spatial renumbering breaks body contiguity, and the JAX
    dispatch never takes them with an emit mask) on the dense floor."""
    return dataclasses.replace(config, body_nodes=0, body_node_offset=0, body_faces=(),
                               budget=dataclasses.replace(config.budget, body_stride=1),
                               dense_floor=True, **SUPER_OFF)


@dataclass
class _Ops:
    """The substep's wrappers: the kernels, or every plain twin; with
    ``net`` (over ranks) the outer bands exchanged before each refresh and
    reduce, and the CG's partials gathered."""

    plain: bool
    width: int  # B, the halo band
    net: Transport | None = None

    def __post_init__(self):
        self.k = pd._PLAIN if self.plain else pd._KERNELS
        self._refresh = halo.refresh_plain if self.plain else halo.refresh
        self._reduce = halo.reduce_plain if self.plain else halo.reduce
        self.merge = halo.merge_plain if self.plain else halo.merge
        self.merge_pairs = halo.merge_pairs_plain if self.plain else halo.merge_pairs
        self.apply = assembly.apply_system_plain if self.plain else assembly.apply_system

    def refresh(self, own: torch.Tensor, zero: bool = False) -> torch.Tensor:
        """T30's refresh of the owned ``f32[D, L, ...]``; over ranks the
        first slab's head goes to the rank before and the last slab's tail
        to the rank after, and theirs fill the outer halos."""
        b, bands = self.width, (None, None)
        if self.net is not None and not zero:
            bands = self.net.exchange(own[0, :b], own[-1, own.shape[1] - b:])
        return self._refresh(own, b, zero, *bands)

    def reduce(self, view: torch.Tensor, mode: int = halo.SUM, **kw):
        """T30's reduce of the views ``f32[D, V, ...]``; over ranks the
        first slab's left-halo partials go to the rank before and the last
        slab's right-halo partials to the rank after, and theirs are added
        to the outer owned bands."""
        b, bands = self.width, (None, None)
        if self.net is not None:
            bands = self.net.exchange(view[0, :b], view[-1, view.shape[1] - b:])
        return self._reduce(view, b, mode, **kw, left=bands[0], right=bands[1])


def _detect(ops: _Ops, meta: DomainMeta, st: DomainStatic, xv, pv, params, config, failed,
            active_view, counters):
    """Each slab's contacts on its view with its emit mask, gathered into
    the flat scene's lists (T16/T17, T25 and T20, then T30's merge)."""
    d, v = meta.n_slabs, meta.view
    x3, p3 = xv.view(d, v, 3), pv.view(d, v, 3)
    dev = xv.device
    over = []
    colls = CollisionSet(floor_active=active_view)
    pt_on = config.enable_collisions and st.triangles.shape[1] > 0
    edge_on = config.enable_edge_collisions and st.triangles.shape[1] > 0
    if pt_on:
        outs = [broadphase.detect_point_tri_collisions(
            x3[s], p3[s], st.tri_mask[s], params, config, failed=failed, plain=ops.plain,
            triangles=st.triangles[s], emit=st.tri_emit_mask[s]) for s in range(d)]
        idx, mask, cnt = (torch.stack([o[j] for o in outs]) for j in range(3))
        over += [o[3] for o in outs]
        colls.pt_idx, colls.pt_mask, colls.pt_count = ops.merge(idx, mask, cnt, idx.shape[1], v)
    if edge_on:
        outs = []
        for s in range(d):
            ov = torch.zeros(1, dtype=torch.int32, device=dev)
            outs.append(broadphase.detect_edge_edge_collisions(
                x3[s], p3[s], st.triangles[s], st.tri_mask[s], params, config, ov, failed,
                ops.plain, st.tri_emit_mask[s]))
            over.append(ov)
        idx, mask, cnt, hits = (torch.stack([o[j] for o in outs]) for j in range(4))
        colls.edge_idx, colls.edge_mask, colls.edge_count = ops.merge(idx, mask, cnt,
                                                                      idx.shape[1], v)
        colls.edge_hits = hits.sum(0).to(torch.int32)
    if config.enable_node_collisions:
        cap = config.budget.max_node_node_contacts
        caches = stack_members([broadphase.detect_node_node_pairs(
            x3[s], st.radius_view[s], st.node_mask_view[s], params, config, failed, ops.plain,
            st.node_emit[s]) for s in range(d)])
        m = ops.merge_pairs(caches, cap, v)
        i32 = dict(dtype=torch.int32, device=dev)
        colls.nn = NodePairCache(pi=m["pi"], pj=m["pj"], count=m["count"],
                                 ref=torch.empty((d * v, 3), device=dev),
                                 fresh=torch.ones(1, **i32), row_off=m["row_off"],
                                 inc_start=m["inc_start"], inc_pair=m["inc_pair"],
                                 rebuilt=torch.ones(1, **i32))
        colls.nn_cap = d * cap
    colls.overflow = (torch.stack(over).amax(0) if over
                      else torch.zeros(1, dtype=torch.int32, device=dev))
    if counters is not None:
        if pt_on:
            counters["contacts"].add_(colls.pt_count[0])
        if edge_on:
            counters["edge_contacts"].add_(colls.edge_count[0])
            counters["edge_hits"].add_(colls.edge_hits[0])
    return colls, pt_on, edge_on


def _operator(ops: _Ops, meta: DomainMeta, topo: Topology, mass_v, wf_v, h2: float, failed,
              full=None, edges=None):
    """The domain CG's operator over the slabs' owned nodes (refresh, T10
    over the flat views, reduce): ``matvec(vec f32[D·L, 3], part=False) ->
    (A·vec f32[D·L, 3], partials)``; with ``part`` (True, or the slots to
    write into) also the block partials of vec·A·vec over the owned nodes,
    else None."""
    d, l, v = meta.n_slabs, meta.block, meta.view
    flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731

    def matvec(vec, part=False):
        y, _ = ops.apply(flat(ops.refresh(vec.view(d, l, 3))), mass_v, wf_v, h2, topo,
                         **({} if ops.plain else dict(failed=failed)), full=full, edges=edges)
        if part is False:
            return flat(ops.reduce(y.view(d, v, 3))), None
        out, parts = ops.reduce(y.view(d, v, 3), p=vec.view(d, l, 3),
                                part=None if part is True else part)
        return flat(out), parts

    return matvec


def operator(dom: Domain, params: PhysicsParams, plain: bool = False, mesh: Mesh | None = None):
    """The domain CG's operator without contacts and floor weight, over the
    slabs ``dom`` holds (the whole domain, or with ``mesh`` this rank's,
    exchanging with the other ranks): ``matvec(vec, part)`` as the CG
    calls it (:func:`_operator`), the kernels' or, with ``plain``, the
    twins', with a latch of its own (unset).  The checks hold it to the
    single scene's T10."""
    meta = local_meta(dom.meta, mesh)
    st = dom.static
    dev = st.mass_own_view.device
    ops = _Ops(plain, meta.halo, Transport(mesh) if mesh is not None else None)
    wf = torch.zeros(meta.n_slabs * meta.view, device=dev)
    return _operator(ops, meta, st.topo, st.mass_own_view.reshape(-1), wf, pd._h_h2(params)[1],
                     torch.zeros(2, dtype=torch.int32, device=dev))


def _substep(ds: DomainState, st: DomainStatic, params: PhysicsParams, config: StepConfig,
             meta: DomainMeta, ops: _Ops, fold: bool, counters) -> torch.Tensor:
    """One PD substep of every slab (``domain.py:659-981``), in place on
    ``ds``; returns the residual of the last CG (a device scalar)."""
    d, l, b, v = meta.n_slabs, meta.block, meta.halo, meta.view
    k = ops.k
    h, h2 = pd._h_h2(params)
    failed = ds.sim_failed
    topo = st.topo
    dev = ds.positions.device
    full_coupling = config.contact_coupling == "full"
    refresh = ops.refresh
    flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
    pos3, prev3 = ds.positions, ds.prev_positions
    own = SolverState(positions=flat(pos3), prev_positions=flat(prev3),
                      velocities=flat(ds.velocities), forces=torch.empty_like(flat(pos3)),
                      inv_mass=st.own.inv_mass, mass=st.own.mass, radius=st.own.mass,
                      node_mask=st.own.node_mask, sim_failed=failed)

    # Head over the owned nodes (T3): inertia estimate, floor detection,
    # diagonal m/h² + stiffness + floor; then the views (T30).
    x_own, msn_own, diag_own0, wf_own, active_own = k["head"](own, st.own, params, config, fold)
    x3 = x_own.view(d, l, 3)
    xv = flat(refresh(x3))
    wf_view = flat(refresh(wf_own.view(d, l), True))
    active_view = flat(refresh(active_own.view(d, l), True))
    msn_view = flat(refresh(msn_own.view(d, l, 3), True))
    diag_view = flat(refresh(diag_own0.view(d, l), True))
    if counters is not None:
        live = failed[0] == 0
        counters["floor_active"].add_(torch.where(live, active_own.sum(), 0.0).to(torch.int64))
    node_on = config.enable_node_collisions
    inv_mass_v, mass_v = flat(st.inv_mass_view), flat(st.mass_view)
    mass_own_v, radius_v = flat(st.mass_own_view), flat(st.radius_view)
    view_state = SolverState(positions=xv, prev_positions=None, velocities=None, forces=None,
                             inv_mass=inv_mass_v, mass=mass_v, radius=radius_v,
                             node_mask=flat(st.node_mask_view), sim_failed=failed)
    colls = inc = ptd = full = edges = nodes = None
    pt_on = edge_on = False
    if config.enable_collisions or config.enable_edge_collisions or node_on:
        view_state.prev_positions = flat(refresh(prev3))
        colls, pt_on, edge_on = _detect(ops, meta, st, xv, view_state.prev_positions, params,
                                        config, failed, active_view, counters)

    # The contacts' setups over the views (T7, T27, T26), the diagonal
    # reduced to the owned nodes (T30).
    static_diag = wf_view
    if node_on or (not full_coupling and (pt_on or edge_on)):
        static_diag = wf_view.clone()
    sd = None if static_diag is wf_view else static_diag
    if pt_on:
        inc, ptd = k["setup"](colls, mass_own_v, topo, h2, diag_view, wf_view, failed,
                              None if full_coupling else sd)
        if full_coupling:
            full = assembly.FullCoupling(colls, inc, params.collision_thickness)
    if node_on:
        nodes = k["node_setup"](colls.nn, colls.nn_cap, mass_own_v, radius_v, inv_mass_v, topo,
                                h2, diag_view, wf_view, failed, sd, inc, ptd, not full_coupling,
                                colls.pt_count)
        if counters is not None:
            counters["node_pairs"].add_(nodes.lim[0])
    if edge_on:
        edges = k["edge_setup"](colls, mass_own_v, inv_mass_v, topo, h2, diag_view, wf_view,
                                params.collision_thickness, config.reference_quirks,
                                full_coupling, failed, sd, inc, ptd, nodes, colls.pt_count)
    diag_own = flat(ops.reduce(diag_view.view(d, v)))
    matvec = _operator(ops, meta, topo, mass_own_v, static_diag, h2, failed, full, edges)

    # PD iterations: local step over the views (T12, T13, T9), force (T9,
    # with T7, T23, T26 and T27's terms) reduced to the owned nodes, CG.
    plane = floor_plane(params, config.reference_quirks)
    quats = flat(ds.shape_quats)
    x_it, static_view = x_own, None
    prr = torch.zeros(1, dtype=torch.float32, device=dev)
    for _ in range(config.iterations):
        xv = flat(refresh(x_it.view(d, l, 3)))
        rows = assembly.local_step(xv, inv_mass_v, mass_v, quats, topo,
                                   config.rotation_iterations, failed, ops.plain)
        pt = None
        if pt_on and not full_coupling:
            contact = k["pt_force"](xv, colls, inc, params.collision_thickness, failed)
            pt = (ptd, contact, inc.row_start, colls.pt_count)
        force, static_view = k["assemble"](xv, msn_view, wf_view, rows, topo, plane, failed, pt,
                                           full, None, edges, nodes)
        f_own = flat(ops.reduce(force.view(d, v, 3)))
        x_it, prr, trips = k["pcg"](f_own, x_it, diag_own, None, None, h2, st.own.node_mask,
                                    None, config.cg_iterations, config.cg_rtol, failed,
                                    matvec=matvec, ranks=ops.net)
        if counters is not None:
            counters["cg_trips"].add_(trips[0])
    x_it = x_it.contiguous()
    static_own = (static_view.view(d, v, 3)[:, b:b + l].contiguous()
                  if static_view is not None else x_it.view(d, l, 3))

    # Stabilization (domain.py:868-919): each pass's accumulators (T8 in
    # its accumulate-only mode) reduced, averaged and applied (T30), the
    # floor snap after the last kind.
    x3 = x_it.view(d, l, 3)
    no_pt = CollisionSet(floor_active=active_view)
    if config.collision_stabilization_iterations > 0 and (pt_on or edge_on):
        for _ in range(config.collision_stabilization_iterations):
            for kind in ("pt", "edge"):
                if not (pt_on if kind == "pt" else edge_on):
                    continue
                xv = flat(refresh(x3))
                acc = k["pt_tail"](view_state, params, config, colls if kind == "pt" else no_pt,
                                   inc, xv, xv, None if kind == "pt" else edges, None,
                                   pd.STABILIZE, True)
                last = kind == "edge" or not edge_on
                ops.reduce(acc.view(d, v, 4), halo.APPLY, x_own=x3, prev_own=prev3,
                           active=active_own.view(d, l) if last else None,
                           stat=static_own if last else None, failed=failed)

    # Friction (domain.py:921-953): node-node, then point-triangle at the
    # velocity with the node-node impulse, each accumulator reduced and
    # averaged (T27, T8, T30); T4 adds both, then the floor friction, the
    # state update and the latch over the owned nodes.
    nn_avg = pt_avg = None
    if node_on or pt_on:
        xv = flat(refresh(x3))
        view_state.prev_positions = flat(refresh(prev3))
    if node_on:
        acc, touching = k["node_friction"](xv, view_state, params, nodes, failed, True)
        nn_avg = ops.reduce(acc.view(d, v, 4), halo.AVERAGE)
        if counters is not None:
            counters["touching_pairs"].add_(touching[0])
    if pt_on:
        nn_view = flat(refresh(nn_avg)) if nn_avg is not None else None
        acc = k["pt_tail"](view_state, params, config, colls, inc, xv, xv, None, nn_view,
                           pd.FRICTION, True)
        pt_avg = ops.reduce(acc.view(d, v, 4), halo.AVERAGE)
    tail_colls = CollisionSet(floor_active=active_own,
                              overflow=colls.overflow if colls is not None else None)
    snap = pd.snap_target(config, x_it, flat(static_own))
    k["tail"](own, st.own, params, active_own, x_it, snap, tail_colls, None,
              flat(pt_avg) if pt_avg is not None else None, None,
              flat(nn_avg) if nn_avg is not None else None, pt_avg is not None)
    if ops.net is not None:  # the domain's one latch (domain.py:971-973)
        ops.net.all_reduce_(failed, torch.distributed.ReduceOp.MAX)
    return torch.sqrt(torch.sum(prr))


def make_domain_tick(config: StepConfig, meta: DomainMeta, device=None, plain: bool = False,
                     mesh: Mesh | None = None):
    """The domain tick (``domain.py:984``): ``tick(dstate, dstatic, params,
    counters=None) -> (dstate, residual)`` runs ``time_substeps`` substeps
    of every slab in place on ``dstate`` (returned too) and gives the last
    CG's residual as a device scalar; ``counters`` are ``pd.new_counters``'s
    (summed over the slabs and substeps).  The slab axis lives on one device:
    the state's, CUDA (the kernels) unless it is the CPU (the twins), or
    ``device`` when given, which the state must be on; ``plain`` runs the
    twins on any device.  With ``mesh`` the tick steps this rank's D/R
    slabs of the ``meta.n_slabs`` (:func:`shard_domain`'s), exchanging
    with the other ranks, whose ticks must run alongside it; the residual
    is then the whole domain's on every rank and the counters the rank's
    own (:func:`read_counters`); ``tick.transport`` is the tick's
    :class:`.ranks.Transport` (None on one device).  Raises unless R
    divides D."""
    config = domain_config(config)
    meta = local_meta(meta, mesh)
    ops = _Ops(plain, meta.halo, Transport(mesh) if mesh is not None else None)
    want = None if device is None else torch.device(device)

    def tick(dstate: DomainState, dstatic: DomainStatic, params: PhysicsParams, counters=None):
        if want is not None and dstate.positions.device.type != want.type:
            raise ValueError(f"the domain state is on {dstate.positions.device}, not {want}")
        res = None
        for sub in range(config.time_substeps):
            res = _substep(dstate, dstatic, params, config, meta, ops, sub == 0, counters)
        return dstate, res

    tick.transport = ops.net
    return tick
