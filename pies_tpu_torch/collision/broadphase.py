"""Point-triangle detection on the packed-body layout (port of
``pies_tpu/collision/broadphase.py:37-101,210-644,1271-1355,1641-1766``).

Every collision body owns ``m`` contiguous nodes and ``e`` triangles with
one local corner pattern (a tet of the soup: 4 nodes, 4 faces).  Detection
runs in two kernels, each with a plain PyTorch twin here:

* T5 :func:`body_broadphase` — the body grid and the temporal pair cache:
  swept body AABBs in cell units, the rebuild test against the cache, the
  hash-grid build (insertion cells, counts, scan, fill, per-bucket order),
  the cell queries with their caps and latches, the exact/slack AABB tiers
  with deduplication, and the cache update.
* T6 :func:`pt_narrowphase` — phase 1 (proximity decided, plane crossings
  flagged) on every (body, slot) lane, the prox-first lane compaction,
  phase 2 (the coplanarity cubic) on compacted lanes with crossings, and the
  compaction and decode of the hit (corner, face) combos into contacts.

The JAX package's TPU workarounds are not ported (width tiers, forced
transposes, one-hot lookups, ``optimization_barrier``); everything runs at
the full static width, and its width-independent results are kept.  The
order that decides what survives a cap is the JAX package's: bucket entries
in entry order, candidates in query-cell order, lanes in (class, body,
slot) order and contacts in (lane, combo) order.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..options import PhysicsParams, StepConfig
from ..state import BroadphaseCache, empty_broadphase_cache
from .grid import (
    PACKED_MAX_ENTRIES,
    aabb_cell_slots,
    build_grid,
    gather_entries,
    query_buckets,
    table_size_for,
)
from .narrowphase import _sub_c, point_triangle_ccd_cols, point_triangle_phase1_face
from ..ops.math3d import ieee_div as _div

_F32 = np.float32
_CORNER_OFFS = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                        dtype=np.int32)
QUERY_RANGE_CAP = 8  # per-axis cells of a body query window (broadphase.py:284-286)


@dataclass(frozen=True)
class BodyLayout:
    """The packed-body shapes of a scene: ``k`` bodies of ``m`` nodes from
    node ``off``, ``e`` faces each (local corners ``faces``), ``nb`` narrow
    slots, ``bmax`` raw candidates, ``cap`` contacts, a grid of ``h``
    slots."""

    k: int
    m: int
    e: int
    off: int
    faces: tuple
    nb: int
    bmax: int
    cells_cap: int
    entries_cap: int
    cap: int
    h: int

    @property
    def lanes(self) -> int:
        return self.k * self.nb

    @property
    def pcap(self) -> int:
        """Pair buffer: twice the contact cap, so crossing-only lanes do not
        starve proximity lanes (broadphase.py:397-401)."""
        return 2 * self.cap

    @property
    def entries(self) -> int:
        return 8 * self.k


def packed(config: StepConfig) -> bool:
    """Whether detection takes the packed-body path."""
    return (config.broadphase_mode != "reference" and config.budget.body_stride > 1
            and config.body_nodes > 0)


def check_packed(config: StepConfig) -> None:
    """Raise for the detection branches that are not ported yet."""
    if not packed(config):
        raise NotImplementedError(
            "point-triangle detection off the packed-body layout (the super-body,"
            " all-pairs, cell-list and reference broadphases) is ROADMAP queue 1"
            " item 6"
        )


def body_layout(config: StepConfig, n_tris: int) -> BodyLayout:
    b = config.budget
    e, m = b.body_stride, config.body_nodes
    if m * e > 32:
        raise ValueError("the packed-body path needs m·e <= 32 combo bits")
    k = n_tris // e
    return BodyLayout(
        k=k, m=m, e=e, off=config.body_node_offset, faces=tuple(config.body_faces),
        nb=b.max_narrow_bodies, bmax=b.max_candidates_per_body,
        cells_cap=b.max_cells_per_tri, entries_cap=b.max_entries_per_cell,
        cap=b.max_point_tri_contacts, h=table_size_for(2 * k),
    )


@dataclass(frozen=True)
class Scalars:
    """The float32 scalars of detection, as the JAX package computes them
    from ``PhysicsParams`` on the device."""

    cell: float
    slack: float  # world units
    slack_c: float  # cell units
    margin: float  # CCD threshold in cell units
    exact_margin: float  # margin − 2·slack_c (the exact tier)
    size_limit: float  # 2 − margin (the oversize latch)
    thr: float  # CCD threshold, world units


def scalars(params: PhysicsParams) -> Scalars:
    cell = _F32(params.broadphase_cell)
    slack = _F32(params.broadphase_slack)
    slack_c = slack / cell
    margin = _F32(params.collision_threshold_distance) / cell
    return Scalars(
        cell=float(cell), slack=float(slack), slack_c=float(slack_c),
        margin=float(margin), exact_margin=float(margin - _F32(2.0) * slack_c),
        size_limit=float(_F32(2.0) - margin),
        thr=float(_F32(params.collision_threshold_distance)),
    )


def _live_bodies(tri_mask: torch.Tensor, lay: BodyLayout) -> torch.Tensor:
    return (tri_mask[: lay.k * lay.e] > 0).view(lay.k, lay.e).any(dim=1)


def _insertion_slots(lo, hi, live):
    """The home cell ``floor(lo)`` plus, on each axis where the body spans
    more than one cell, the next cell over: ``(coords i32[K, 8, 3], valid
    bool[K, 8])`` (``broadphase.py:1333-1355``)."""
    home = torch.floor(lo).to(torch.int32)
    oversize = (hi - lo) > 1.0
    offs = torch.from_numpy(_CORNER_OFFS).to(lo.device)
    coords = home[:, None, :] + offs[None]
    allowed = ((offs[None] == 0) | oversize[:, None, :]).all(dim=-1)
    return coords, allowed & live[:, None]


def _aabb_prefilter_pack(cand, valid, lo, hi, margin, exact_margin, narrow):
    """Keep candidates whose AABBs overlap (inflated by ``margin``), exact
    overlaps (``exact_margin``) before slack-only ones, each tier by body id
    with duplicates dropped, into ``narrow`` slots (``broadphase.py:
    1641-1766``).  Returns ``(packed, packed_valid, narrow_over,
    exact_over)``; slots past the valid prefix hold 0."""
    k, b = cand.shape
    c = cand.long()
    a_lo, a_hi = lo[c], hi[c]
    ov = valid & ((a_lo <= hi[:, None] + margin) & (a_hi >= lo[:, None] - margin)).all(-1)
    ex = valid & ((a_lo <= hi[:, None] + exact_margin)
                  & (a_hi >= lo[:, None] - exact_margin)).all(-1)
    key = 2 - 2 * ex.long() - (ov & ~ex).long()
    srt = torch.sort(key * (1 << 32) + c, dim=1).values
    skey, sid = srt >> 32, srt & 0xFFFFFFFF
    dup = torch.cat([torch.zeros_like(skey[:, :1], dtype=torch.bool),
                     (sid[:, 1:] == sid[:, :-1]) & (skey[:, 1:] < 2)], dim=1)
    key2 = torch.where(dup, 2, skey)
    order = torch.sort(key2, dim=1, stable=True).indices
    packed_full = torch.gather(sid, 1, order)
    total = (key2 < 2).sum(dim=1)
    exact_total = (key2 == 0).sum(dim=1)
    if b < narrow:
        packed_full = torch.cat([packed_full, packed_full.new_zeros(k, narrow - b)], 1)
    slot = torch.arange(narrow, device=cand.device)[None, :]
    pvalid = slot < torch.clamp_max(total, narrow)[:, None]
    packed_ = torch.where(pvalid, packed_full[:, :narrow], 0).to(torch.int32)
    return packed_, pvalid, bool((total > narrow).any()), bool((exact_total > narrow).any())


def body_broadphase_plain(x, prev, tri_mask, cache: BroadphaseCache, lay: BodyLayout,
                          sc: Scalars, overflow: torch.Tensor,
                          failed: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of kernel T5: the body broadphase with the temporal cache,
    in place on ``cache``; ORs the capacity latch into ``overflow`` i32[1].
    Returns i32[1], 1 when the pairs were rebuilt.  Nothing changes when
    latch slot 0 of ``failed`` is set."""
    rebuilt = torch.zeros(1, dtype=torch.int32, device=x.device)
    if failed is not None and bool(failed[0]):
        return rebuilt
    k, m, off = lay.k, lay.m, lay.off
    x_body, p_body = x[off: off + k * m], prev[off: off + k * m]
    xb, pb = x_body.view(k, m, 3), p_body.view(k, m, 3)
    live = _live_bodies(tri_mask, lay)
    lo = _div(torch.minimum(xb.amin(1), pb.amin(1)), sc.cell) - sc.slack_c
    hi = _div(torch.maximum(xb.amax(1), pb.amax(1)), sc.cell) + sc.slack_c
    lo = torch.where(live[:, None], lo, 0.0)
    hi = torch.where(live[:, None], hi, 0.0)
    size_over = bool((((hi - lo) > sc.size_limit).any(-1) & live).any())

    # Rebuild when the cache is stale or some body node moved more than the
    # slack on an axis; a NaN displacement compares false, as jnp.max does.
    disp = torch.maximum((x_body - cache.ref).abs().amax(), (p_body - cache.ref).abs().amax())
    if bool(cache.fresh[0]) and not bool(disp > sc.slack):
        return rebuilt
    rebuilt.fill_(1)

    ins_coords, ins_valid = _insertion_slots(lo, hi, live)
    grid = build_grid(ins_coords, ins_valid, lay.h)
    q_coords, q_valid, _ = aabb_cell_slots(lo - 1.0, hi, lay.cells_cap, QUERY_RANGE_CAP)
    start, offsets, total, gather_over = query_buckets(grid, q_coords, q_valid & live[:, None],
                                                       lay.entries_cap)
    cand, valid = gather_entries(grid, start, offsets, total, lay.bmax)
    cand = torch.clamp_max(cand, k - 1)
    valid = valid & (cand != torch.arange(k, dtype=torch.int32, device=x.device)[:, None])
    pairs, pvalid, narrow_over, exact_over = _aabb_prefilter_pack(
        cand, valid, lo, hi, sc.margin, sc.exact_margin, lay.nb)
    cache.pairs.copy_(pairs)
    cache.valid.copy_(pvalid.to(torch.int32))
    cache.ref.copy_(x_body)
    cache.fresh.fill_(0 if narrow_over else 1)
    if size_over or bool((gather_over & live).any()) or exact_over:
        overflow.fill_(1)
    return rebuilt


def body_broadphase(x, prev, tri_mask, cache: BroadphaseCache, lay: BodyLayout,
                    sc: Scalars, overflow: torch.Tensor,
                    failed: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel T5 on CUDA tensors, :func:`body_broadphase_plain` on CPU
    tensors (same arguments and result).  On the card ``failed`` is
    required."""
    if kernels.on_cpu(x):
        return body_broadphase_plain(x, prev, tri_mask, cache, lay, sc, overflow, failed)
    if failed is None:
        raise ValueError("the broadphase kernel needs the failure latch")
    if lay.bmax > 64 or lay.m > 8:
        raise ValueError("the broadphase kernel takes at most 64 candidates and 8 nodes"
                         " per body")
    dev = x.device
    kernels.require(dev, x, prev, tri_mask, cache.pairs, cache.valid, cache.ref,
                    cache.fresh, overflow, failed)
    i32 = dict(dtype=torch.int32, device=dev)
    count = torch.zeros(lay.h, **i32)
    cursor = torch.zeros(lay.h, **i32)
    start = torch.empty(lay.h + 1, **i32)
    partial = torch.empty(kernels.scan_partials(lay.h), **i32)
    entries = torch.empty(lay.entries, **i32)
    bounds = torch.empty((2, lay.k, 3), dtype=torch.float32, device=dev)
    flags = torch.zeros(8, **i32)
    err = kernels.lib().pies_body_broadphase(
        x.data_ptr(), prev.data_ptr(), tri_mask.data_ptr(), cache.pairs.data_ptr(),
        cache.valid.data_ptr(), cache.ref.data_ptr(), cache.fresh.data_ptr(),
        count.data_ptr(), cursor.data_ptr(), start.data_ptr(), partial.data_ptr(),
        entries.data_ptr(), bounds.data_ptr(), flags.data_ptr(), overflow.data_ptr(),
        failed.data_ptr(), lay.k, lay.m, lay.e, lay.off, lay.nb, lay.bmax, lay.cells_cap,
        lay.entries_cap, lay.h, int(lay.entries >= PACKED_MAX_ENTRIES), sc.cell, sc.slack,
        sc.slack_c, sc.margin, sc.exact_margin, sc.size_limit, kernels.stream(),
    )
    kernels.check(err, "body_broadphase")
    body_broadphase.launches += 1
    return flags[6:7]  # kRebuild


body_broadphase.launches = 0


def _cols(v: torch.Tensor):
    return (v[..., 0], v[..., 1], v[..., 2])


def pt_narrowphase_plain(x, prev, tri_mask, cache: BroadphaseCache, lay: BodyLayout,
                         sc: Scalars, overflow: torch.Tensor,
                         failed: torch.Tensor | None = None, stats: dict | None = None):
    """Plain twin of kernel T6: the narrowphase of the cached pairs at the
    current positions.  Returns ``(pt_idx i32[cap, 4], pt_mask f32[cap],
    pt_count i32[1])`` with the live contacts a packed prefix; ORs the
    proximity-lane eviction latch into ``overflow``.  ``stats``, when given,
    receives the work counts: live lanes, compacted lanes, crossing combos
    solved by the cubic, and contacts before the cap."""
    dev = x.device
    k, m, e, nb, off, cap = lay.k, lay.m, lay.e, lay.nb, lay.off, lay.cap
    pt_idx = torch.zeros((cap, 4), dtype=torch.int32, device=dev)
    pt_mask = torch.zeros(cap, dtype=torch.float32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    if failed is not None and bool(failed[0]):
        return pt_idx, pt_mask, count
    xb = x[off: off + k * m].view(k, m, 3)
    pb = prev[off: off + k * m].view(k, m, 3)
    live = _live_bodies(tri_mask, lay)
    own = torch.arange(k, dtype=torch.int32, device=dev)[:, None]
    ok = ((cache.valid > 0) & (cache.pairs != own) & live[:, None]).reshape(-1)
    other = cache.pairs.reshape(-1).long()

    # Phase 1 on every lane, face-major.
    o_prev, o_now = pb[other], xb[other]
    own_prev = [_cols(pb[:, c].repeat_interleave(nb, 0)) for c in range(m)]
    own_now = [_cols(xb[:, c].repeat_interleave(nb, 0)) for c in range(m)]
    bits_prox = torch.zeros(k * nb, dtype=torch.int64, device=dev)
    bits_cross = torch.zeros_like(bits_prox)
    for f, (i0, i1, i2) in enumerate(lay.faces):
        b0, b1 = _cols(o_prev[:, i0]), _cols(o_now[:, i0])
        per_corner = point_triangle_phase1_face(
            b0, _sub_c(_cols(o_prev[:, i1]), b0), _sub_c(_cols(o_prev[:, i2]), b0),
            b1, _sub_c(_cols(o_now[:, i1]), b1), _sub_c(_cols(o_now[:, i2]), b1),
            own_prev, own_now, sc.thr)
        for c, (prox, crossing) in enumerate(per_corner):
            bits_prox |= (prox & ok).long() << (c * e + f)
            bits_cross |= (crossing & ok).long() << (c * e + f)

    # Proximity lanes first, then crossing-only lanes, each by lane id.
    key = torch.where(bits_prox > 0, 0, torch.where(bits_cross > 0, 1, 2))
    order = torch.sort(key, stable=True).indices
    pcap_eff = min(lay.pcap, k * nb)
    n_live = min(int((key < 2).sum()), pcap_eff)
    if int((bits_prox > 0).sum()) > pcap_eff:
        overflow.fill_(1)
    lane = order[:n_live]
    prox_c, cross_c = bits_prox[lane], bits_cross[lane]

    # Phase 2: the cubic, only for the crossing combos of compacted lanes.
    bits_ccd = torch.zeros_like(prox_c)
    sel = torch.nonzero(cross_c > 0).reshape(-1)
    if sel.numel():
        ln = lane[sel]
        bo, ot = ln // nb, other[ln]
        own_p, own_n, oth_p, oth_n = pb[bo], xb[bo], pb[ot], xb[ot]
        cs = cross_c[sel]
        acc = torch.zeros_like(cs)
        for c in range(m):
            ap0c, ap1c = _cols(own_p[:, c]), _cols(own_n[:, c])
            for f, (i0, i1, i2) in enumerate(lay.faces):
                b0, b1 = _cols(oth_p[:, i0]), _cols(oth_n[:, i0])
                hit, _ = point_triangle_ccd_cols(
                    _sub_c(ap0c, b0), _sub_c(_cols(oth_p[:, i1]), b0),
                    _sub_c(_cols(oth_p[:, i2]), b0), _sub_c(ap1c, b1),
                    _sub_c(_cols(oth_n[:, i1]), b1), _sub_c(_cols(oth_n[:, i2]), b1), sc.thr)
                sh = c * e + f
                need = ((cs >> sh) & 1) > 0
                acc |= (hit & need).long() << sh
        bits_ccd[sel] = acc
    pbits = prox_c | bits_ccd

    # Hit combos in (lane, combo) order into the contact buffer, decoded.
    n_combo = m * e
    combo_hit = (pbits[:, None] >> torch.arange(n_combo, device=dev)[None, :]) & 1
    hits = torch.nonzero(combo_hit.reshape(-1) > 0).reshape(-1)[:cap]
    n = hits.numel()
    if stats is not None:
        ones = [bin(v).count("1") for v in cross_c.tolist()]
        stats.update(live_lanes=int(ok.sum()), compacted_lanes=n_live,
                     cross_combos=sum(ones), contacts=int(combo_hit.sum()))
    if n:
        slot, combo = hits // n_combo, hits % n_combo
        ln = lane[slot]
        b, ot = ln // nb, other[ln]
        c, f = combo // e, combo % e
        faces = torch.tensor(lay.faces, dtype=torch.int64, device=dev)
        pt_idx[:n, 0] = (off + b * m + c).to(torch.int32)
        pt_idx[:n, 1:] = (off + ot[:, None] * m + faces[f]).to(torch.int32)
        pt_mask[:n] = 1.0
    count.fill_(n)
    return pt_idx, pt_mask, count


def pt_narrowphase(x, prev, tri_mask, cache: BroadphaseCache, lay: BodyLayout, sc: Scalars,
                   overflow: torch.Tensor, failed: torch.Tensor | None = None):
    """Kernel T6 on CUDA tensors, :func:`pt_narrowphase_plain` on CPU
    tensors (same arguments and results).  On the card the count stays on
    the device and ``failed`` is required."""
    if kernels.on_cpu(x):
        return pt_narrowphase_plain(x, prev, tri_mask, cache, lay, sc, overflow, failed)
    if failed is None:
        raise ValueError("the narrowphase kernel needs the failure latch")
    if lay.m > 8 or lay.m * lay.e > 32:
        raise ValueError("the narrowphase kernel takes m <= 8 and m·e <= 32")
    dev = x.device
    kernels.require(dev, x, prev, tri_mask, cache.pairs, cache.valid, overflow, failed)
    i32 = dict(dtype=torch.int32, device=dev)
    lanes, pcap, cap = lay.lanes, lay.pcap, lay.cap
    bits = torch.empty((2, lanes), **i32)
    pair_buf = torch.empty(pcap, **i32)
    pbits = torch.empty(pcap, **i32)
    if lanes >= 1 << 31:
        raise ValueError("the narrowphase kernel takes fewer than 2^31 lanes")
    partial = torch.empty(kernels.scan_partials(lanes) + kernels.scan_partials(pcap),
                          dtype=torch.int64, device=dev)
    totals = torch.zeros(4, dtype=torch.int64, device=dev)
    faces = torch.tensor(lay.faces, **i32)
    pt_idx = torch.empty((cap, 4), **i32)
    pt_mask = torch.empty(cap, dtype=torch.float32, device=dev)
    pt_count = torch.empty(1, **i32)
    err = kernels.lib().pies_pt_narrowphase(
        x.data_ptr(), prev.data_ptr(), tri_mask.data_ptr(), cache.pairs.data_ptr(),
        cache.valid.data_ptr(), faces.data_ptr(), bits.data_ptr(), pair_buf.data_ptr(),
        pbits.data_ptr(), partial.data_ptr(), totals.data_ptr(), pt_idx.data_ptr(),
        pt_mask.data_ptr(), pt_count.data_ptr(), overflow.data_ptr(), failed.data_ptr(),
        lay.k, lay.m, lay.e, lay.off, lay.nb, cap, sc.thr, kernels.stream(),
    )
    kernels.check(err, "pt_narrowphase")
    pt_narrowphase.launches += 1
    return pt_idx, pt_mask, pt_count


pt_narrowphase.launches = 0


def detect_point_tri_collisions(x, prev, tri_mask, params: PhysicsParams, config: StepConfig,
                                cache: BroadphaseCache | None = None,
                                failed: torch.Tensor | None = None, plain: bool = False):
    """Point-triangle contacts of one substep on the packed-body path
    (``broadphase.py:37-101``).  With a cache of the scene's shape, it is
    used and updated in place; without one every call rebuilds (a fresh
    cache with zero slack gives exactly that).  Returns ``(pt_idx, pt_mask,
    pt_count, overflow, rebuilt)``; ``overflow`` and ``rebuilt`` are i32[1]
    device flags."""
    check_packed(config)
    lay = body_layout(config, tri_mask.shape[0])
    if not (cache is not None and config.bp_cache
            and tuple(cache.pairs.shape) == (lay.k, lay.nb)):
        cache = empty_broadphase_cache(lay.k, lay.nb, lay.k * lay.m, x.device)
        params = dataclasses.replace(params, broadphase_slack=0.0)
    sc = scalars(params)
    overflow = torch.zeros(1, dtype=torch.int32, device=x.device)
    bf, nf = ((body_broadphase_plain, pt_narrowphase_plain) if plain
              else (body_broadphase, pt_narrowphase))
    rebuilt = bf(x, prev, tri_mask, cache, lay, sc, overflow, failed)
    pt_idx, pt_mask, pt_count = nf(x, prev, tri_mask, cache, lay, sc, overflow, failed)
    return pt_idx, pt_mask, pt_count, overflow, rebuilt
