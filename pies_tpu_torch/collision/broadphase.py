"""Point-triangle detection (port of ``pies_tpu/collision/broadphase.py:
37-1181,1257-1448,1551-1900``): every branch of the JAX package's dispatch.

On the packed-body layout every collision body owns ``m`` contiguous nodes
and ``e`` triangles with one local corner pattern (a tet of the soup: 4
nodes, 4 faces).  Detection runs in two kernels, each with a plain PyTorch
twin here:

* T5 :func:`body_broadphase` — the body grid and the temporal pair cache:
  swept body AABBs in cell units, the rebuild test against the cache, the
  hash-grid build (insertion cells, counts, scan, fill, per-bucket order),
  the cell queries with their caps and latches, the exact/slack AABB tiers
  with deduplication, and the cache update.
* T6 :func:`pt_narrowphase` — phase 1 (proximity decided, plane crossings
  flagged) on every live (body, slot) lane, phase 2 (the coplanarity cubic)
  on its crossings, the prox-first lane order and the decode of the hit
  (corner, face) combos into contacts; one cooperative launch whose blocks
  own contiguous lane ranges (the plain twin compacts, then solves).

The super-body layout covers any triangle scene (``StepConfig.super_*``): a
packed prefix of such bodies and one "loose" row per remaining triangle,
every row's corner nodes in the ``corners`` table.  The same two stages run
as kernels T14 :func:`super_broadphase` (the query window absorbs the CCD
margin, rows sharing a node are dropped through the static ``adj`` table
before the prefilter, a truncated raw gather latches, and the cache's
reference spans all nodes) and T15 :func:`super_narrowphase` (the static
(corner, face) combos with their class masks, contacts decoded through
``corners``).

Every other scene takes one of the per-triangle branches (``TriLayout``):
all-pairs for at most ``allpairs_broadphase_max`` triangles, the cell list
for larger ones, per-body cell lists for a uniform body stride without the
packed node layout, and the reference's multi-cell sweep under
``broadphase_mode="reference"``.  They share two kernels: T16
:func:`tri_candidates` (each branch's candidates, packed ascending into a
row per triangle, with the latches as device flags) and T17
:func:`tri_ccd` (the CCD of each own corner against each candidate, the
hits compacted in the JAX package's chunk-major order).  These branches
keep no cache.

An ensemble (``x`` f32[B, N, 3], the cache, overflow and results with a
leading member axis; ROADMAP items 10a and 10b-ii) takes every branch, and
the edge-edge detection (T16, T25) and the node-pair prefix (T20; item
10b-iii), and the PBD node-node response with each member's pair cache
kept across ticks (T20, T21; item 10b-iv), with the same launches as one
scene: each kernel's ``blockIdx.y`` is the member, with its own grid,
cache, compactions, counts and latches, and each plain twin runs member by
member (``state.each_member``).

The JAX package's TPU workarounds are not ported (width tiers, forced
transposes, one-hot lookups, ``optimization_barrier``); everything runs at
the full static width, and its width-independent results are kept.  The
order that decides what survives a cap is the JAX package's: bucket entries
in entry order, candidates in query-cell order, lanes in (class, body,
slot) order and contacts in (lane, combo) order on the body layouts, and in
(chunk of 8 slots, triangle, slot, corner) order on the per-triangle ones.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..options import PhysicsParams, StepConfig
from ..state import (
    BroadphaseCache,
    each_member,
    empty_broadphase_cache,
    empty_node_pair_cache,
    members_of,
    pair_incidence,
    stack_members,
)
from .batches import Incidence, csr_sum
from .grid import (
    PACKED_MAX_ENTRIES,
    aabb_cell_slots,
    build_grid,
    gather_candidates,
    gather_entries,
    query_buckets,
    table_size_for,
)
from .narrowphase import (
    _cols,
    _sub_c,
    edge_edge_ccd,
    point_triangle_ccd,
    point_triangle_ccd_cols,
    point_triangle_phase1_face,
)
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


def super_body(config: StepConfig) -> bool:
    """Whether detection takes the super-body path (``broadphase.py:84``)."""
    return config.broadphase_mode != "reference" and not packed(config) and config.super_k > 0


def check_detection(config: StepConfig) -> None:
    """Raise for a configuration no detection branch takes."""
    if config.broadphase_mode not in ("celllist", "reference"):
        raise ValueError(f"broadphase_mode must be 'celllist' or 'reference', got"
                         f" {config.broadphase_mode!r}")


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


def _aabb_prefilter_pack(cand, valid, lo, hi, margin, exact_margin, narrow,
                         rows: slice = slice(None)):
    """Keep candidates whose AABBs overlap (inflated by ``margin``), exact
    overlaps (``exact_margin``) before slack-only ones, each tier by id
    with duplicates dropped, into ``narrow`` slots (``broadphase.py:
    1641-1766``).  ``cand`` and ``valid`` hold the rows ``rows`` of the
    bounds ``lo``, ``hi``.  Returns ``(packed, packed_valid, narrow_over,
    exact_over)``, the latches as bool tensors; slots past the valid prefix
    hold 0."""
    k, b = cand.shape
    c = cand.long()
    a_lo, a_hi = lo[c], hi[c]
    r_lo, r_hi = lo[rows][:, None], hi[rows][:, None]
    ov = valid & ((a_lo <= r_hi + margin) & (a_hi >= r_lo - margin)).all(-1)
    ex = valid & ((a_lo <= r_hi + exact_margin) & (a_hi >= r_lo - exact_margin)).all(-1)
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
    return packed_, pvalid, (total > narrow).any(), (exact_total > narrow).any()


def body_broadphase_plain(x, prev, tri_mask, cache: BroadphaseCache, lay: BodyLayout,
                          sc: Scalars, overflow: torch.Tensor,
                          failed: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of kernel T5: the body broadphase with the temporal cache,
    in place on ``cache``; ORs the capacity latch into ``overflow`` i32[1].
    Writes ``cache.rebuilt`` i32[1], 1 when the pairs were rebuilt, and
    returns it.  When latch slot 0 of ``failed`` is set nothing else
    changes and the flag is 0.  An ensemble (``x`` f32[B, N, 3], a batched
    cache, ``overflow`` and the flag i32[B, 1]) runs member by member."""
    if members_of(x):
        each_member(lambda xb, pb, cb, ob, fb: body_broadphase_plain(
            xb, pb, tri_mask, cb, lay, sc, ob, fb), members_of(x), x, prev, cache, overflow, failed)
        return cache.rebuilt
    rebuilt = cache.rebuilt
    rebuilt.zero_()
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
    required, and the call is one cooperative launch that allocates
    nothing; the flag it returns is ``cache.rebuilt``, the cache's own
    word, which the next call on that cache overwrites."""
    if kernels.on_cpu(x):
        return body_broadphase_plain(x, prev, tri_mask, cache, lay, sc, overflow, failed)
    if failed is None:
        raise ValueError("the broadphase kernel needs the failure latch")
    if lay.bmax > 64 or lay.m > 8 or lay.nb <= 0:
        raise ValueError("the broadphase kernel takes at most 64 candidates and 8 nodes"
                         " per body, and narrow slots")
    dev = x.device
    kernels.require(dev, x, prev, tri_mask, cache.pairs, cache.valid, cache.ref,
                    cache.fresh, cache.rebuilt, overflow, failed)
    lead = x.shape[:-2]  # (B,) for an ensemble: a table, bounds and flags per member
    if tuple(cache.rebuilt.shape) != lead + (1,):
        raise ValueError(f"the cache's rebuilt flag must be {list(lead + (1,))}")
    b = max(members_of(x), 1)
    grid, words = broadphase_grid(dev, b, lay.k, lay.h)
    # (scratch, a row a member: counts, which the kernel leaves zero,
    # starts, tile sums, entries, bounds, the flag words and the query's
    # row counter)
    work = kernels.scratch(("T5 work", lay.h), lead + (words,), torch.int32, dev, zeroed=True)
    err = kernels.lib().pies_body_broadphase(
        x.data_ptr(), prev.data_ptr(), tri_mask.data_ptr(), cache.pairs.data_ptr(),
        cache.valid.data_ptr(), cache.ref.data_ptr(), cache.fresh.data_ptr(),
        cache.rebuilt.data_ptr(), work.data_ptr(), overflow.data_ptr(), failed.data_ptr(),
        lay.k, lay.m, lay.e, lay.off, lay.nb, lay.bmax, lay.cells_cap, lay.entries_cap, lay.h,
        int(lay.entries >= PACKED_MAX_ENTRIES), grid,
        sc.cell, sc.slack, sc.slack_c, sc.margin, sc.exact_margin, sc.size_limit, x.shape[-2],
        b, kernels.stream(),
    )
    kernels.check(err, "body_broadphase")
    body_broadphase.launches += 1
    return cache.rebuilt


body_broadphase.launches = 0


@functools.lru_cache(maxsize=64)
def broadphase_grid(device: torch.device, members: int, k: int, h: int) -> tuple[int, int]:
    """Blocks per member of T5's cooperative grid on ``device`` and the
    int32 scratch words a member takes (members past what one launch
    keeps resident go to further launches)."""
    lib = kernels.lib()
    grid = lib.pies_body_broadphase_grid(members, k)
    if grid <= 0:
        raise RuntimeError("the broadphase: no block of the cooperative kernel stays resident")
    words = lib.pies_body_broadphase_words(k, h, grid)
    if words <= 0:
        raise ValueError("the broadphase kernel takes fewer than 2^31 scratch words a member")
    return grid, words


def face_table(faces, device: torch.device) -> torch.Tensor:
    """The local corner patterns ``faces`` (three corners each) as i32[e, 3]
    on ``device``, made once per pattern and device: the narrowphase
    kernels T6 and T15 read it on every call, and a fresh copy from host
    memory would block the host each time."""
    return _face_table(tuple(tuple(int(c) for c in f) for f in faces), device)


@functools.lru_cache(maxsize=64)
def _face_table(faces: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(faces, dtype=torch.int32, device=device).reshape(-1, 3)


@functools.lru_cache(maxsize=64)
def narrowphase_grid(device: torch.device, members: int, lanes: int) -> int:
    """Blocks per member of T6's cooperative grid on ``device`` (its scratch
    is sized by it; members past what one launch keeps resident go to
    further launches)."""
    grid = kernels.lib().pies_pt_narrowphase_grid(members, lanes)
    if grid <= 0:
        raise RuntimeError("the narrowphase: no block of the cooperative kernel stays resident")
    return grid


def pt_narrowphase_plain(x, prev, tri_mask, cache: BroadphaseCache, lay: BodyLayout,
                         sc: Scalars, overflow: torch.Tensor,
                         failed: torch.Tensor | None = None, stats: dict | None = None):
    """Plain twin of kernel T6: the narrowphase of the cached pairs at the
    current positions.  Returns ``(pt_idx i32[cap, 4], pt_mask f32[cap],
    pt_count i32[1])`` with the live contacts a packed prefix; ORs the
    proximity-lane eviction latch into ``overflow``.  ``stats``, when given,
    receives the work counts: live lanes, compacted lanes, crossing combos
    solved by the cubic, and contacts before the cap.  An ensemble runs
    member by member (``pt_idx`` i32[B, cap, 4], node ids local to each
    member, ``pt_count`` i32[B, 1]; ``stats`` not taken)."""
    if members_of(x):
        return each_member(lambda xb, pb, cb, ob, fb: pt_narrowphase_plain(
            xb, pb, tri_mask, cb, lay, sc, ob, fb), members_of(x), x, prev, cache, overflow, failed)
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
    lanes, cap = lay.lanes, lay.cap
    if lay.m * lay.e > 32 or lanes <= 0 or cap <= 0:
        raise ValueError("the narrowphase kernel takes m·e <= 32, lanes and a contact cap")
    dev = x.device
    kernels.require(dev, x, prev, tri_mask, cache.pairs, cache.valid, overflow, failed)
    lead = x.shape[:-2]  # (B,) for an ensemble: every buffer per member
    b = max(members_of(x), 1)
    if b * max(lanes * lay.m * lay.e, 4 * cap, x.shape[-2] * 3) >= 1 << 31:
        raise ValueError("the narrowphase kernel takes fewer than 2^31 lane combos in all")
    grid = narrowphase_grid(dev, b, lanes)
    # (scratch, each call writing it before reading it: per block a range
    # of lane items, the block table, the kept hit count)
    items = kernels.scratch("T6 items", lead + (grid * -(-lanes // grid), 4), torch.int32, dev)
    table = kernels.scratch("T6 table", lead + (grid, 2), torch.int64, dev)
    kept = kernels.scratch("T6 kept", lead + (1,), torch.int64, dev)
    faces = face_table(lay.faces, dev)
    pt_idx = torch.empty(lead + (cap, 4), dtype=torch.int32, device=dev)
    pt_mask = torch.empty(lead + (cap,), dtype=torch.float32, device=dev)
    pt_count = torch.empty(lead + (1,), dtype=torch.int32, device=dev)
    err = kernels.lib().pies_pt_narrowphase(
        x.data_ptr(), prev.data_ptr(), tri_mask.data_ptr(), cache.pairs.data_ptr(),
        cache.valid.data_ptr(), faces.data_ptr(), items.data_ptr(), table.data_ptr(),
        kept.data_ptr(), pt_idx.data_ptr(), pt_mask.data_ptr(), pt_count.data_ptr(),
        overflow.data_ptr(), failed.data_ptr(), lay.k, lay.m, lay.e, lay.off, lay.nb, cap,
        sc.thr, x.shape[-2], b, grid, kernels.stream(),
    )
    kernels.check(err, "pt_narrowphase")
    pt_narrowphase.launches += 1
    return pt_idx, pt_mask, pt_count


pt_narrowphase.launches = 0


def _fresh_cache(k: int, nb: int, m: int, x: torch.Tensor) -> BroadphaseCache:
    """An unpopulated cache for the positions ``x``: one per member of an
    ensemble, stacked."""
    cache = empty_broadphase_cache(k, nb, m, x.device)
    return stack_members([cache.clone() for _ in range(x.shape[0])]) if members_of(x) else cache


def detect_point_tri_collisions(x, prev, tri_mask, params: PhysicsParams, config: StepConfig,
                                cache: BroadphaseCache | None = None,
                                failed: torch.Tensor | None = None, plain: bool = False,
                                corners: torch.Tensor | None = None,
                                adj: torch.Tensor | None = None,
                                triangles: torch.Tensor | None = None,
                                emit: torch.Tensor | None = None):
    """Point-triangle contacts of one substep, dispatched as
    ``broadphase.py:74-101`` does: the reference sweep, the packed-body
    path, the super-body path (with the scene's ``corners`` and ``adj``
    tables), the per-body cell list, all-pairs, or the cell list; the
    per-triangle branches need ``triangles``.  ``emit`` (f32[T]) restricts
    the triangles whose corners are tested (the domain decomposition's
    owned triangles): the all-pairs, cell-list and reference branches
    take it, as in the JAX package, and no other does.  With a cache of the scene's
    shape, the body paths use and update it in place; without one every
    call rebuilds (a fresh cache with zero slack gives exactly that).
    Returns ``(pt_idx, pt_mask, pt_count, overflow, rebuilt)``; ``overflow``
    and ``rebuilt`` are i32[1] device flags (``rebuilt`` stays 0 on the
    per-triangle branches, which have no cache).  An ensemble (``x``
    f32[B, N, 3] and a batched cache, created per member when absent) takes
    the same branch with per-member results, i32[B, ...]."""
    check_detection(config)
    mode = tri_mode(config, tri_mask.shape[0])
    lead = x.shape[:-2]  # (B,) for an ensemble
    if emit is not None and mode not in ("allpairs", "celllist", "reference"):
        raise ValueError("an emit mask needs the all-pairs, cell-list or reference branch")
    if mode is not None:
        if triangles is None:
            raise ValueError(f"the {mode} detection needs the scene's triangles")
        return _detect_tri(x, prev, triangles, tri_mask, params, config, failed, plain, mode,
                           emit)
    if super_body(config):
        return _detect_super(x, prev, params, config, cache, failed, plain, corners, adj)
    lay = body_layout(config, tri_mask.shape[0])
    if not (cache is not None and config.bp_cache
            and tuple(cache.pairs.shape) == lead + (lay.k, lay.nb)):
        cache = _fresh_cache(lay.k, lay.nb, lay.k * lay.m, x)
        params = dataclasses.replace(params, broadphase_slack=0.0)
    sc = scalars(params)
    overflow = torch.zeros(lead + (1,), dtype=torch.int32, device=x.device)
    bf, nf = ((body_broadphase_plain, pt_narrowphase_plain) if plain
              else (body_broadphase, pt_narrowphase))
    rebuilt = bf(x, prev, tri_mask, cache, lay, sc, overflow, failed)
    pt_idx, pt_mask, pt_count = nf(x, prev, tri_mask, cache, lay, sc, overflow, failed)
    return pt_idx, pt_mask, pt_count, overflow, rebuilt


# ---------------------------------------------------------------------------
# the super-body layout: kernels T14 and T15


@dataclass(frozen=True)
class SuperLayout:
    """The super-body shapes of a scene (``StepConfig.super_*``): ``k`` rows
    of ``w`` corner slots, ``live_k`` of them live, the first ``kp`` packed
    bodies; ``faces`` the local corner patterns of all face slots, the first
    ``e_packed`` for packed candidates and slot ``loose_face`` for loose
    ones; ``a`` shared-node neighbours per row (0 without the table); ``nb``
    narrow slots, ``bmax`` raw candidates, ``cap`` contacts, a grid of ``h``
    slots."""

    k: int
    kp: int
    live_k: int
    w: int
    faces: tuple
    e_packed: int
    loose_face: int
    a: int
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
        return 2 * self.cap

    @property
    def entries(self) -> int:
        return 8 * self.k

    @property
    def n_face(self) -> int:
        return len(self.faces)

    @property
    def n_combo(self) -> int:
        return self.w * self.n_face

    def combos(self):
        """The statically live (corner, face) combos with their class gates
        (``broadphase.py:865-883``): ``(c, f, row_packed, cand)`` where
        ``row_packed`` says the emitting row must be packed (a corner slot
        past 2 beside loose rows) and ``cand`` is None, "packed" or "loose":
        the class the candidate row must have for face slot ``f``."""
        loose_exists = self.live_k > self.kp
        out = []
        for c in range(self.w):
            if c >= 3 and not self.kp:
                continue
            row_packed = c >= 3 and loose_exists
            for f in range(self.n_face):
                p_ok = self.kp > 0 and f < self.e_packed
                l_ok = loose_exists and f == self.loose_face
                if not (p_ok or l_ok):
                    continue
                if p_ok and l_ok:
                    cand = None
                elif p_ok:
                    cand = "packed" if loose_exists else None
                else:
                    cand = "loose" if self.kp else None
                out.append((c, f, row_packed, cand))
        return out

    def combo_bits(self):
        """The combos as four bit masks over ``c·n_face + f``: live, needing
        a packed row, needing a packed candidate, needing a loose one."""
        live = row_packed = cand_packed = cand_loose = 0
        for c, f, rp, cand in self.combos():
            bit = 1 << (c * self.n_face + f)
            live |= bit
            row_packed |= bit if rp else 0
            cand_packed |= bit if cand == "packed" else 0
            cand_loose |= bit if cand == "loose" else 0
        return live, row_packed, cand_packed, cand_loose


def super_layout(config: StepConfig, corners: torch.Tensor,
                 adj: torch.Tensor | None) -> SuperLayout:
    b = config.budget
    k, kp = config.super_k, config.super_packed_k
    w = config.super_packed_m if kp else 3
    if tuple(corners.shape) != (k, w):
        raise ValueError(f"corners must be [{k}, {w}], got {tuple(corners.shape)}")
    if w * len(config.super_faces) > 32:
        raise ValueError("the super-body path needs W·faces <= 32 combo bits")
    if adj is not None and adj.shape[0] != k:
        raise ValueError("adj must have one row per body row")
    return SuperLayout(
        k=k, kp=kp, live_k=config.super_live_k, w=w, faces=tuple(config.super_faces),
        e_packed=config.super_packed_e, loose_face=config.super_loose_face,
        a=0 if adj is None else adj.shape[1], nb=b.max_narrow_bodies,
        bmax=b.max_candidates_per_body, cells_cap=b.max_cells_per_tri,
        entries_cap=b.max_entries_per_cell, cap=b.max_point_tri_contacts,
        h=table_size_for(2 * k),
    )


def _super_live(lay: SuperLayout, device) -> torch.Tensor:
    return torch.arange(lay.k, dtype=torch.int32, device=device) < lay.live_k


def super_broadphase_plain(x, prev, corners, adj, cache: BroadphaseCache, lay: SuperLayout,
                           sc: Scalars, overflow: torch.Tensor,
                           failed: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of kernel T14: the super-body broadphase with the temporal
    cache (``broadphase.py:710-849``), in place on ``cache``; ORs the
    capacity latch (oversize row, saturated bucket, exact-tier eviction,
    truncated raw gather) into ``overflow`` i32[1].  Returns i32[1], 1 when
    the pairs were rebuilt.  Nothing changes when latch slot 0 of ``failed``
    is set.  An ensemble (``x`` f32[B, N, 3], a batched cache, ``overflow``
    and the result i32[B, 1]) runs member by member."""
    if members_of(x):
        return each_member(lambda xb, pb, cb, ob, fb: super_broadphase_plain(
            xb, pb, corners, adj, cb, lay, sc, ob, fb), members_of(x), x, prev, cache, overflow,
            failed)
    rebuilt = torch.zeros(1, dtype=torch.int32, device=x.device)
    if failed is not None and bool(failed[0]):
        return rebuilt
    # A NaN displacement compares false, as jnp.max does.
    disp = torch.maximum((x - cache.ref).abs().amax(), (prev - cache.ref).abs().amax())
    if bool(cache.fresh[0]) and not bool(disp > sc.slack):
        return rebuilt
    rebuilt.fill_(1)

    k = lay.k
    # Padding corners repeat corner 0, so they never widen a row's box.
    xb, pb = x[corners.long()], prev[corners.long()]
    live = _super_live(lay, x.device)
    lo = _div(torch.minimum(xb.amin(1), pb.amin(1)), sc.cell) - sc.slack_c
    hi = _div(torch.maximum(xb.amax(1), pb.amax(1)), sc.cell) + sc.slack_c
    lo = torch.where(live[:, None], lo, 0.0)
    hi = torch.where(live[:, None], hi, 0.0)
    size_over = bool((((hi - lo) > sc.size_limit).any(-1) & live).any())

    ins_coords, ins_valid = _insertion_slots(lo, hi, live)
    grid = build_grid(ins_coords, ins_valid, lay.h)
    # The window absorbs the margin on both sides (broadphase.py:745-756).
    q_coords, q_valid, _ = aabb_cell_slots(lo - sc.margin - 1.0, hi + sc.margin,
                                           lay.cells_cap, QUERY_RANGE_CAP)
    start, offsets, total, gather_over = query_buckets(grid, q_coords, q_valid & live[:, None],
                                                       lay.entries_cap)
    trunc_over = bool(((total > lay.bmax) & live).any())
    narrow_over = exact_over = False
    own = torch.arange(k, dtype=torch.int32, device=x.device)[:, None]
    # Rows are independent from here on: blocks of rows keep the [rows, 512]
    # intermediates of a large scene small.
    for r0 in range(0, k, SUPER_TWIN_ROWS):
        rows = slice(r0, min(r0 + SUPER_TWIN_ROWS, k))
        cand, valid = gather_entries(grid, start[rows], offsets[rows], total[rows], lay.bmax)
        cand = torch.clamp_max(cand, k - 1)
        valid = valid & (cand != own[rows])
        if adj is not None:
            for a in range(adj.shape[1]):
                valid = valid & (cand != adj[rows, a][:, None])
        pairs, pvalid, n_over, e_over = _aabb_prefilter_pack(
            cand, valid, lo, hi, sc.margin, sc.exact_margin, lay.nb, rows)
        cache.pairs[rows] = pairs
        cache.valid[rows] = pvalid.to(torch.int32)
        narrow_over, exact_over = narrow_over or n_over, exact_over or e_over
    cache.ref.copy_(x)
    cache.fresh.fill_(0 if narrow_over else 1)
    if size_over or bool((gather_over & live).any()) or exact_over or trunc_over:
        overflow.fill_(1)
    return rebuilt


SUPER_TWIN_ROWS = 1 << 16  # rows the plain twin gathers and packs at a time
SUPER_MAX_RAW = 512  # kMaxRaw of kernels/csrc/super_broadphase.cu
SUPER_MAX_CELLS = 64  # kMaxCells
SUPER_MAX_ADJ = 64  # kMaxAdj
SUPER_FLAGS = ("exceed", "nan", "size_over", "gather_over", "narrow_over", "exact_over",
               "rebuild", "trunc_over")


def super_broadphase(x, prev, corners, adj, cache: BroadphaseCache, lay: SuperLayout,
                     sc: Scalars, overflow: torch.Tensor,
                     failed: torch.Tensor | None = None, flags_out: list | None = None):
    """Kernel T14 on CUDA tensors, :func:`super_broadphase_plain` on CPU
    tensors (same arguments and result).  On the card ``failed`` is
    required; ``flags_out``, when given, receives the kernel's flag words
    i32[8] (``SUPER_FLAGS``: which latch fired; i32[B, 8] for an
    ensemble)."""
    if kernels.on_cpu(x):
        return super_broadphase_plain(x, prev, corners, adj, cache, lay, sc, overflow, failed)
    if failed is None:
        raise ValueError("the broadphase kernel needs the failure latch")
    if (lay.bmax > SUPER_MAX_RAW or lay.cells_cap > SUPER_MAX_CELLS or lay.a > SUPER_MAX_ADJ
            or lay.w > 8):
        raise ValueError(
            f"the super-body broadphase kernel takes at most {SUPER_MAX_RAW} raw candidates,"
            f" {SUPER_MAX_CELLS} query cells, {SUPER_MAX_ADJ} neighbours and 8 corners per row")
    dev = x.device
    n = x.shape[-2]
    lead = x.shape[:-2]  # (B,) for an ensemble: a table, bounds and flags per member
    members = kernels.launch_members(x, failed, prev, cache.pairs, cache.valid, cache.ref,
                                     cache.fresh, overflow)
    if (tuple(cache.ref.shape) != lead + (n, 3)
            or tuple(cache.pairs.shape) != lead + (lay.k, lay.nb)):
        raise ValueError("the cache does not have the scene's super-body shapes")
    kernels.require(dev, x, prev, corners, adj, cache.pairs, cache.valid, cache.ref,
                    cache.fresh, overflow, failed)
    i32 = dict(dtype=torch.int32, device=dev)
    # Scratch of a rebuild; the kernel zeroes the counts and cursors itself,
    # and only when it rebuilds.
    count = torch.empty(lead + (lay.h,), **i32)
    cursor = torch.empty(lead + (lay.h,), **i32)
    start = torch.empty(lead + (lay.h + 1,), **i32)
    partial = torch.empty(lead + (kernels.scan_partials(lay.h),), **i32)
    entries = torch.empty(lead + (lay.entries,), **i32)
    bounds = torch.empty(lead + (2, lay.k, 3), dtype=torch.float32, device=dev)
    flags = torch.zeros(lead + (8,), **i32)
    err = kernels.lib().pies_super_broadphase(
        x.data_ptr(), prev.data_ptr(), corners.data_ptr(), kernels.ptr(adj),
        cache.pairs.data_ptr(), cache.valid.data_ptr(), cache.ref.data_ptr(),
        cache.fresh.data_ptr(), count.data_ptr(), cursor.data_ptr(), start.data_ptr(),
        partial.data_ptr(), entries.data_ptr(), bounds.data_ptr(), flags.data_ptr(),
        overflow.data_ptr(), failed.data_ptr(), n, lay.k, lay.live_k, lay.w, lay.a, lay.nb,
        lay.bmax, lay.cells_cap, lay.entries_cap, lay.h,
        int(lay.entries >= PACKED_MAX_ENTRIES), sc.cell, sc.slack, sc.slack_c, sc.margin,
        sc.exact_margin, sc.size_limit, members, kernels.stream(),
    )
    kernels.check(err, "super_broadphase")
    super_broadphase.launches += 1
    if flags_out is not None:
        flags_out.append(flags)
    return flags[..., 6:7]  # kRebuild


super_broadphase.launches = 0


def super_narrowphase_plain(x, prev, corners, cache: BroadphaseCache, lay: SuperLayout,
                            sc: Scalars, overflow: torch.Tensor,
                            failed: torch.Tensor | None = None, stats: dict | None = None):
    """Plain twin of kernel T15: the narrowphase of the cached row pairs at
    the current positions (``broadphase.py:850-1085``).  Returns ``(pt_idx
    i32[cap, 4], pt_mask f32[cap], pt_count i32[1])`` with the live contacts
    a packed prefix; ORs the proximity-lane eviction latch into
    ``overflow``.  ``stats``, when given, receives the work counts: live
    lanes, compacted lanes, crossing combos solved by the cubic, and
    contacts before the cap.  An ensemble runs member by member
    (``pt_idx`` i32[B, cap, 4], ``pt_count`` i32[B, 1]; ``stats`` not
    taken)."""
    if members_of(x):
        return each_member(lambda xb, pb, cb, ob, fb: super_narrowphase_plain(
            xb, pb, corners, cb, lay, sc, ob, fb), members_of(x), x, prev, cache, overflow,
            failed)
    dev = x.device
    k, w, nb, cap, kp, nf = lay.k, lay.w, lay.nb, lay.cap, lay.kp, lay.n_face
    pt_idx = torch.zeros((cap, 4), dtype=torch.int32, device=dev)
    pt_mask = torch.zeros(cap, dtype=torch.float32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    if failed is not None and bool(failed[0]):
        return pt_idx, pt_mask, count
    cl = corners.long()
    xb, pb = x[cl], prev[cl]
    live = _super_live(lay, dev)
    own = torch.arange(k, dtype=torch.int32, device=dev)[:, None]
    ok = ((cache.valid > 0) & (cache.pairs != own) & live[:, None]).reshape(-1)
    other = cache.pairs.reshape(-1).long()
    gates = {None: ok, "packed": ok & (other < kp), "loose": ok & (other >= kp)}
    row_packed = (own < kp).expand(k, nb).reshape(-1)
    combos = lay.combos()

    # Phase 1 on every lane, face-major, over the statically live combos.
    o_prev, o_now = pb[other], xb[other]
    own_prev = [_cols(pb[:, c].repeat_interleave(nb, 0)) for c in range(w)]
    own_now = [_cols(xb[:, c].repeat_interleave(nb, 0)) for c in range(w)]
    bits_prox = torch.zeros(k * nb, dtype=torch.int64, device=dev)
    bits_cross = torch.zeros_like(bits_prox)
    for f in sorted({f for _, f, _, _ in combos}):
        i0, i1, i2 = lay.faces[f]
        f_combos = [cm for cm in combos if cm[1] == f]
        b0, b1 = _cols(o_prev[:, i0]), _cols(o_now[:, i0])
        per_corner = point_triangle_phase1_face(
            b0, _sub_c(_cols(o_prev[:, i1]), b0), _sub_c(_cols(o_prev[:, i2]), b0),
            b1, _sub_c(_cols(o_now[:, i1]), b1), _sub_c(_cols(o_now[:, i2]), b1),
            [own_prev[c] for c, _, _, _ in f_combos], [own_now[c] for c, _, _, _ in f_combos],
            sc.thr)
        for (c, _, rp, cand), (prox, crossing) in zip(f_combos, per_corner):
            mok = gates[cand] & row_packed if rp else gates[cand]
            bits_prox |= (prox & mok).long() << (c * nf + f)
            bits_cross |= (crossing & mok).long() << (c * nf + f)

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
        for c, f, _, _ in combos:
            i0, i1, i2 = lay.faces[f]
            ap0c, ap1c = _cols(own_p[:, c]), _cols(own_n[:, c])
            b0, b1 = _cols(oth_p[:, i0]), _cols(oth_n[:, i0])
            hit, _ = point_triangle_ccd_cols(
                _sub_c(ap0c, b0), _sub_c(_cols(oth_p[:, i1]), b0),
                _sub_c(_cols(oth_p[:, i2]), b0), _sub_c(ap1c, b1),
                _sub_c(_cols(oth_n[:, i1]), b1), _sub_c(_cols(oth_n[:, i2]), b1), sc.thr)
            sh = c * nf + f
            need = ((cs >> sh) & 1) > 0
            acc |= (hit & need).long() << sh
        bits_ccd[sel] = acc
    pbits = prox_c | bits_ccd

    # Hit combos in (lane, combo) order into the contact buffer, decoded
    # through the corner table.
    n_combo = lay.n_combo
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
        c, f = combo // nf, combo % nf
        faces = torch.tensor(lay.faces, dtype=torch.int64, device=dev)
        pt_idx[:n, 0] = corners[b, c]
        pt_idx[:n, 1:] = torch.gather(corners[ot], 1, faces[f]).to(torch.int32)
        pt_mask[:n] = 1.0
    count.fill_(n)
    return pt_idx, pt_mask, count


def super_narrowphase(x, prev, corners, cache: BroadphaseCache, lay: SuperLayout, sc: Scalars,
                      overflow: torch.Tensor, failed: torch.Tensor | None = None):
    """Kernel T15 on CUDA tensors, :func:`super_narrowphase_plain` on CPU
    tensors (same arguments and results).  On the card the count stays on
    the device and ``failed`` is required; a latched scene or member gets
    an empty contact buffer, as from the twin."""
    if kernels.on_cpu(x):
        return super_narrowphase_plain(x, prev, corners, cache, lay, sc, overflow, failed)
    if failed is None:
        raise ValueError("the narrowphase kernel needs the failure latch")
    if lay.w > 8 or lay.n_combo > 32:
        raise ValueError("the narrowphase kernel takes W <= 8 and W·faces <= 32")
    dev = x.device
    kernels.require(dev, x, prev, corners, cache.pairs, cache.valid, overflow, failed)
    members = kernels.launch_members(x, failed, prev, cache.pairs, cache.valid, overflow)
    lead = x.shape[:-2]  # (B,) for an ensemble: every buffer per member
    i32 = dict(dtype=torch.int32, device=dev)
    lanes, pcap, cap = lay.lanes, lay.pcap, lay.cap
    if members * max(lanes, 4 * cap, x.shape[-2] * 3) >= 1 << 31:
        raise ValueError("the narrowphase kernel takes fewer than 2^31 lanes in all")
    bits = torch.empty(lead + (2, lanes), **i32)
    pair_buf = torch.empty(lead + (pcap,), **i32)
    pbits = torch.empty(lead + (pcap,), **i32)
    partial = torch.empty(members * (kernels.scan_partials(lanes) + kernels.scan_partials(pcap)),
                          dtype=torch.int64, device=dev)
    totals = torch.zeros(lead + (4,), dtype=torch.int64, device=dev)
    faces = face_table(lay.faces, dev)
    masks = [m if m < 1 << 31 else m - (1 << 32) for m in lay.combo_bits()]
    pt_idx = torch.empty(lead + (cap, 4), **i32)
    pt_mask = torch.empty(lead + (cap,), dtype=torch.float32, device=dev)
    pt_count = torch.empty(lead + (1,), **i32)
    err = kernels.lib().pies_super_narrowphase(
        x.data_ptr(), prev.data_ptr(), corners.data_ptr(), cache.pairs.data_ptr(),
        cache.valid.data_ptr(), faces.data_ptr(), bits.data_ptr(), pair_buf.data_ptr(),
        pbits.data_ptr(), partial.data_ptr(), totals.data_ptr(), pt_idx.data_ptr(),
        pt_mask.data_ptr(), pt_count.data_ptr(), overflow.data_ptr(), failed.data_ptr(),
        lay.k, lay.kp, lay.live_k, lay.w, lay.n_face, lay.nb, cap, *masks, sc.thr,
        x.shape[-2], members, kernels.stream(),
    )
    kernels.check(err, "super_narrowphase")
    super_narrowphase.launches += 1
    return pt_idx, pt_mask, pt_count


super_narrowphase.launches = 0


def _detect_super(x, prev, params: PhysicsParams, config: StepConfig,
                  cache: BroadphaseCache | None, failed, plain: bool, corners, adj):
    """The super-body branch of :func:`detect_point_tri_collisions`."""
    if corners is None:
        raise ValueError("the super-body detection needs the scene's corner table")
    lay = super_layout(config, corners, adj)
    lead = x.shape[:-2]
    if not (cache is not None and config.bp_cache
            and tuple(cache.pairs.shape) == lead + (lay.k, lay.nb)
            and tuple(cache.ref.shape) == x.shape):
        cache = _fresh_cache(lay.k, lay.nb, x.shape[-2], x)
        params = dataclasses.replace(params, broadphase_slack=0.0)
    sc = scalars(params)
    overflow = torch.zeros(lead + (1,), dtype=torch.int32, device=x.device)
    bf, nf = ((super_broadphase_plain, super_narrowphase_plain) if plain
              else (super_broadphase, super_narrowphase))
    rebuilt = bf(x, prev, corners, adj, cache, lay, sc, overflow, failed)
    pt_idx, pt_mask, pt_count = nf(x, prev, corners, cache, lay, sc, overflow, failed)
    return pt_idx, pt_mask, pt_count, overflow, rebuilt


# ---------------------------------------------------------------------------
# the per-triangle branches: kernels T16 and T17

TRI_MODES = ("allpairs", "celllist", "bodies", "reference")
# T16's flag words: [0] candidate slots filled over all rows (T17 does
# nothing at 0), then one word per latch.
TRI_FLAGS = ("filled", "size_over", "gather_over", "exact_over", "narrow_over", "ins_over",
             "query_over", "unused")
TRI_MAX_RAW = 1024  # kMaxRaw of kernels/csrc/tri_candidates.cu
TRI_MAX_CELLS = 512  # kMaxCells
TRI_TWIN_ROWS = 1 << 12  # rows the plain twins test or pack at a time


def tri_mode(config: StepConfig, n_tris: int) -> str | None:
    """The per-triangle branch a scene of ``n_tris`` (padded) triangles
    takes, or None for the packed-body and super-body paths
    (``broadphase.py:74-100``)."""
    if config.broadphase_mode == "reference":
        return "reference"
    if packed(config) or super_body(config):
        return None
    if config.budget.body_stride > 1:
        return "bodies"
    return "allpairs" if n_tris <= config.allpairs_broadphase_max else "celllist"


@dataclass(frozen=True)
class TriLayout:
    """The shapes of a per-triangle branch ``mode``: ``t`` triangle rows;
    ``k`` grid items (triangles, or bodies of ``e`` triangles) with ``s``
    insertion slots each; ``cells_cap`` cells per query window,
    ``entries_cap`` entries read per bucket, ``raw`` candidates gathered per
    item, ``nbb`` narrow bodies; ``nb`` candidate slots per triangle (the
    all-pairs branch's escape width ``n2``, else ``max_narrow_candidates``),
    ``cap`` contacts and a grid of ``h`` slots."""

    mode: str
    t: int
    k: int
    e: int
    s: int
    cells_cap: int
    entries_cap: int
    raw: int
    nbb: int
    nb: int
    cap: int
    h: int

    @property
    def chunk(self) -> int:
        """Candidate slots per CCD chunk (``broadphase.py:1802``)."""
        return min(8, self.nb)

    @property
    def nb_padded(self) -> int:
        return -(-self.nb // self.chunk) * self.chunk

    @property
    def lanes(self) -> int:
        return self.t * self.nb_padded

    @property
    def unpacked(self) -> bool:
        """The JAX package's table holds 2^24 entries or more: a bucket
        latches past the hard cap, not at the packed count's saturation."""
        return self.k * self.s >= PACKED_MAX_ENTRIES


def tri_layout(config: StepConfig, n_tris: int, mode: str) -> TriLayout:
    b = config.budget
    t, e, s, raw, nbb = n_tris, 1, 8, b.max_candidates_per_tri, 0
    if mode == "allpairs":
        n1 = min(b.max_narrow_candidates, t)
        nb, h, raw = min(4 * n1, t), 0, 0
    else:
        nb = b.max_narrow_candidates
        h = table_size_for(2 * t)
    if mode == "bodies":
        e, raw, nbb = b.body_stride, b.max_candidates_per_body, b.max_narrow_bodies
        if t % e:
            raise ValueError(f"{t} triangles are not bodies of {e}")
        h = table_size_for(2 * (t // e))
    elif mode == "reference":
        s = b.max_cells_per_tri
        h = min(table_size_for(t * s, 1.0), 1 << 22)
    return TriLayout(mode=mode, t=t, k=t // e, e=e, s=s, cells_cap=b.max_cells_per_tri,
                     entries_cap=b.max_entries_per_cell, raw=raw, nbb=nbb, nb=nb,
                     cap=b.max_point_tri_contacts, h=h)


def tri_scalars(params: PhysicsParams, config: StepConfig) -> Scalars:
    """The scalars of a per-triangle branch: cell units of
    ``broadphase_cell``, or in reference mode world units (with the
    quirks) or ``grid_spacing`` (``broadphase.py:1578``)."""
    if config.broadphase_mode == "reference":
        scale = 1.0 if config.reference_quirks else params.grid_spacing
        params = dataclasses.replace(params, broadphase_cell=scale)
    return scalars(params)


def tri_swept_aabb(x, prev, triangles, scale: float):
    """Each triangle's AABB over its corners before and now, divided by
    ``scale`` (``_tri_swept_aabb``, ``broadphase.py:1257-1262``)."""
    tl = triangles.long()
    p_now, p_prev = _div(x[tl], scale), _div(prev[tl], scale)
    lo = torch.minimum(p_now.amin(1), p_prev.amin(1))
    hi = torch.maximum(p_now.amax(1), p_prev.amax(1))
    return lo, hi


def _allpairs_plain(lo, hi, triangles, live, lay: TriLayout, sc: Scalars, flags, emits):
    """All triangles' AABBs against all (``broadphase.py:104-207``):
    overlaps with the margin between live triangles that share no node,
    the rows of emitting triangles only (``emits``), each row's packed
    ascending into ``nb`` slots; ``narrow_over`` when a row has more."""
    t, nb, dev = lay.t, lay.nb, lo.device
    cand = torch.zeros((t, nb), dtype=torch.int32, device=dev)
    count = torch.zeros(t, dtype=torch.int32, device=dev)
    cols = torch.arange(t, device=dev)
    for r0 in range(0, t, TRI_TWIN_ROWS):
        rows = slice(r0, min(r0 + TRI_TWIN_ROWS, t))
        ov = ((lo[None] <= hi[rows, None] + sc.margin)
              & (hi[None] >= lo[rows, None] - sc.margin)).all(-1)
        ov &= (live & emits)[rows, None] & live[None, :] & (cols[None, :] != cols[rows, None])
        for a in range(3):
            for b in range(3):
                ov &= triangles[rows, a, None] != triangles[None, :, b]
        pos = ov.cumsum(1) - 1
        r, c = torch.nonzero(ov & (pos < nb), as_tuple=True)
        cand[r0 + r, pos[r, c]] = c.to(torch.int32)
        total = ov.sum(1)
        count[rows] = total.clamp_max(nb).to(torch.int32)
        flags[4] |= (total > nb).any().to(torch.int32)
    return cand, count


def _pack_rows(cand, valid, lo, hi, sc: Scalars, narrow: int, flags):
    """The prefilter pack with one tier (``_aabb_prefilter_pack`` with
    ``slack2 = 0``, ``dedup=True``) in blocks of rows: each row's unique
    candidates whose AABB overlaps its own, ascending, into ``narrow``
    slots; ``exact_over`` when a row has more.  Returns ``(packed, count)``."""
    m = cand.shape[0]
    packed = torch.zeros((m, narrow), dtype=torch.int32, device=cand.device)
    count = torch.zeros(m, dtype=torch.int32, device=cand.device)
    for r0 in range(0, m, TRI_TWIN_ROWS):
        rows = slice(r0, min(r0 + TRI_TWIN_ROWS, m))
        p, pv, _, over = _aabb_prefilter_pack(cand[rows], valid[rows], lo, hi, sc.margin,
                                              sc.margin, narrow, rows)
        packed[rows], count[rows] = p, pv.sum(1).to(torch.int32)
        flags[3] |= over.to(torch.int32)
    return packed, count


def _cell_list(lo, hi, live, lay: TriLayout, raw: int, flags, emits=None):
    """One home-cell entry per item (two corners on an oversize axis),
    queries over ``[lo − 1, hi]`` (``broadphase.py:1386-1428``) from the
    emitting items (``emits``, all when None): up to ``raw`` candidate
    items per row, clamped to the item count."""
    ins_coords, ins_valid = _insertion_slots(lo, hi, live)
    grid = build_grid(ins_coords, ins_valid, lay.h)
    q_coords, q_valid, _ = aabb_cell_slots(lo - 1.0, hi, lay.cells_cap, QUERY_RANGE_CAP)
    query = live if emits is None else live & emits
    cand, valid, over = gather_candidates(grid, q_coords, q_valid & query[:, None],
                                          lay.entries_cap, raw)
    flags[2] |= (over & live).any().to(torch.int32)
    return torch.clamp_max(cand, lo.shape[0] - 1), valid


def tri_candidates_plain(x, prev, triangles, tri_mask, lay: TriLayout, sc: Scalars,
                         overflow: torch.Tensor, failed: torch.Tensor | None = None,
                         emit: torch.Tensor | None = None):
    """Plain twin of kernel T16, the candidate stage of a per-triangle
    branch: ``(cand i32[T, nb], count i32[T], flags i32[8])``, each row's
    candidates a packed ascending prefix of ``count`` slots (0 past it) and
    ``flags`` the words of ``TRI_FLAGS``; ORs the latches into ``overflow``.
    Nothing is found when latch slot 0 of ``failed`` is set.  ``emit``
    (f32[T], or None: every triangle) marks the triangles that query: the
    others keep empty rows but stay candidates (the domain decomposition's
    owned triangles; not in the per-body branch).  An ensemble (``x``
    f32[B, N, 3], ``overflow`` i32[B, 1]) runs member by member: ``cand``
    i32[B, T, nb], ``count`` i32[B, T], ``flags`` i32[B, 8]."""
    if members_of(x):
        return each_member(lambda xb, pb, ob, fb: tri_candidates_plain(
            xb, pb, triangles, tri_mask, lay, sc, ob, fb, emit), members_of(x), x, prev,
            overflow, failed)
    dev = x.device
    flags = torch.zeros(8, dtype=torch.int32, device=dev)
    if failed is not None and bool(failed[0]):
        return (torch.zeros((lay.t, lay.nb), dtype=torch.int32, device=dev),
                torch.zeros(lay.t, dtype=torch.int32, device=dev), flags)
    lo, hi = tri_swept_aabb(x, prev, triangles, sc.cell)
    live = tri_mask > 0
    if emit is not None and lay.mode == "bodies":
        raise ValueError("the per-body branch takes no emit mask")
    emits = torch.ones_like(live) if emit is None else emit > 0
    if lay.mode == "allpairs":
        cand, count = _allpairs_plain(lo, hi, triangles, live, lay, sc, flags, emits)
    elif lay.mode == "celllist":
        flags[1] |= ((((hi - lo) > sc.size_limit).any(-1) & live).any()).to(torch.int32)
        raw, valid = _cell_list(lo, hi, live, lay, lay.raw, flags, emits)
        cand, count = _pack_rows(raw, valid, lo, hi, sc, lay.nb, flags)
    elif lay.mode == "bodies":
        # Body boxes over their live triangles (broadphase.py:1117-1166).
        k, e = lay.k, lay.e
        big = 3.0e38
        lo_b = torch.where(live[:, None], lo, big).view(k, e, 3).amin(1)
        hi_b = torch.where(live[:, None], hi, -big).view(k, e, 3).amax(1)
        live_b = live.view(k, e).any(1)
        lo_b = torch.where(live_b[:, None], lo_b, 0.0)
        hi_b = torch.where(live_b[:, None], hi_b, 0.0)
        flags[1] |= ((((hi_b - lo_b) > sc.size_limit).any(-1) & live_b).any()).to(torch.int32)
        raw, valid = _cell_list(lo_b, hi_b, live_b, lay, lay.raw, flags)
        bodies, n_b = _pack_rows(raw, valid, lo_b, hi_b, sc, lay.nbb, flags)
        # Each body's list, expanded to its bodies' triangles, for each of
        # its triangles.
        tri = (bodies.long()[:, :, None] * e + torch.arange(e, device=dev)).reshape(k, -1)
        slot = torch.arange(lay.nbb * e, device=dev)[None, :]
        ok = slot < (n_b.long() * e)[:, None]
        tri, ok = tri.repeat_interleave(e, 0), ok.repeat_interleave(e, 0) & live[:, None]
        cand, count = _pack_rows(tri, ok, lo, hi, sc, lay.nb, flags)
    else:
        # The reference's multi-cell sweep (broadphase.py:1584-1626): the
        # duplicates it gathers are dropped by the pack.
        s = lay.s
        ins_coords, ins_valid, ins_over = aabb_cell_slots(lo, hi, s, 50)
        q_coords, q_valid, q_over = aabb_cell_slots(lo, hi, s, 20)
        grid = build_grid(ins_coords, ins_valid & live[:, None], lay.h)
        raw, valid, over = gather_candidates(grid, q_coords, q_valid & (live & emits)[:, None],
                                             lay.entries_cap, lay.raw)
        flags[2] |= (over & live).any().to(torch.int32)
        flags[5] |= (ins_over & live).any().to(torch.int32)
        flags[6] |= (q_over & live).any().to(torch.int32)
        cand, count = _pack_rows(raw, valid, lo, hi, sc, lay.nb, flags)
    flags[0] = count.sum()
    overflow.bitwise_or_(flags[1:].amax().clamp_max(1).view(1))
    return cand, count, flags


def tri_candidates(x, prev, triangles, tri_mask, lay: TriLayout, sc: Scalars,
                   overflow: torch.Tensor, failed: torch.Tensor | None = None,
                   emit: torch.Tensor | None = None):
    """Kernel T16 on CUDA tensors, :func:`tri_candidates_plain` on CPU
    tensors (same arguments and results).  On the card ``failed`` is
    required."""
    if kernels.on_cpu(x):
        return tri_candidates_plain(x, prev, triangles, tri_mask, lay, sc, overflow, failed,
                                    emit)
    if emit is not None and lay.mode == "bodies":
        raise ValueError("the per-body branch takes no emit mask")
    if failed is None:
        raise ValueError("the candidate kernel needs the failure latch")
    if (lay.raw > TRI_MAX_RAW or lay.cells_cap > TRI_MAX_CELLS
            or lay.nbb * lay.e > TRI_MAX_RAW):
        raise ValueError(f"the candidate kernel takes at most {TRI_MAX_RAW} raw candidates"
                         f" (narrow bodies times body stride) and {TRI_MAX_CELLS} query"
                         " cells per row")
    dev = x.device
    kernels.require(dev, x, prev, triangles, tri_mask, overflow, failed, emit)
    members = kernels.launch_members(x, failed, prev, overflow)
    lead = x.shape[:-2]  # (B,) for an ensemble: every buffer per member
    i32 = dict(dtype=torch.int32, device=dev)
    h = max(lay.h, 1)
    count_h = torch.empty(lead + (h,), **i32)
    cursor = torch.empty(lead + (h,), **i32)
    start = torch.empty(lead + (h + 1,), **i32)
    partial = torch.empty(lead + (kernels.scan_partials(h),), **i32)
    entries = torch.empty(lead + (max(1, lay.k * lay.s),), **i32)
    bounds = torch.empty(lead + (2, lay.t + lay.k, 3), dtype=torch.float32, device=dev)
    bodies = torch.empty(lead + (lay.k, max(1, lay.nbb)), **i32)
    n_bodies = torch.empty(lead + (lay.k,), **i32)
    cand = torch.empty(lead + (lay.t, lay.nb), **i32)
    count = torch.empty(lead + (lay.t,), **i32)
    flags = torch.zeros(lead + (8,), **i32)
    err = kernels.lib().pies_tri_candidates(
        x.data_ptr(), prev.data_ptr(), triangles.data_ptr(), tri_mask.data_ptr(),
        count_h.data_ptr(), cursor.data_ptr(), start.data_ptr(), partial.data_ptr(),
        entries.data_ptr(), bounds.data_ptr(), bodies.data_ptr(), n_bodies.data_ptr(),
        cand.data_ptr(), count.data_ptr(), flags.data_ptr(), overflow.data_ptr(),
        failed.data_ptr(), kernels.ptr(emit), TRI_MODES.index(lay.mode), lay.t, lay.k, lay.e,
        lay.s, lay.cells_cap, lay.entries_cap, lay.raw, lay.nbb, lay.nb, lay.h, int(lay.unpacked),
        sc.cell, sc.margin, sc.size_limit, x.shape[-2], members, kernels.stream(),
    )
    kernels.check(err, "tri_candidates")
    tri_candidates.launches += 1
    return cand, count, flags


tri_candidates.launches = 0


def tri_ccd_plain(x, prev, triangles, cand, count, flags, lay: TriLayout, sc: Scalars,
                  failed: torch.Tensor | None = None, stats: dict | None = None):
    """Plain twin of kernel T17, the CCD stage of the per-triangle branches
    (``_ccd_and_compact``, ``broadphase.py:1769-1900``): each live
    (triangle, slot) pair that shares no node, each of the triangle's three
    corners against the candidate, relative to its first node; hits in
    chunk-major order (chunks of ``chunk`` slots; in a chunk by triangle,
    slot, corner) into ``cap`` contacts.  Returns ``(pt_idx i32[cap, 4],
    pt_mask f32[cap], pt_count i32[1])`` with the contacts a packed prefix.
    ``stats``, when given, receives the live lanes and the hits before the
    cap.  An ensemble runs member by member (``pt_idx`` i32[B, cap, 4],
    ``pt_count`` i32[B, 1]; ``stats`` not taken)."""
    if members_of(x):
        return each_member(lambda xb, pb, cb, nb, fl, fb: tri_ccd_plain(
            xb, pb, triangles, cb, nb, fl, lay, sc, fb), members_of(x), x, prev, cand, count,
            flags, failed)
    dev, cap = x.device, lay.cap
    pt_idx = torch.zeros((cap, 4), dtype=torch.int32, device=dev)
    pt_mask = torch.zeros(cap, dtype=torch.float32, device=dev)
    pt_count = torch.zeros(1, dtype=torch.int32, device=dev)
    if (failed is not None and bool(failed[0])) or int(flags[0]) == 0:
        if stats is not None:
            stats.update(live_lanes=0, contacts=0)
        return pt_idx, pt_mask, pt_count
    t, nb, c, bp = lay.t, lay.nb, lay.chunk, lay.nb_padded
    # Lane l in chunk-major order: chunk l // (t·c), then triangle, then the
    # slot in the chunk.
    lane = torch.arange(lay.lanes, device=dev)
    tri = (lane % (t * c)) // c
    slot = (lane // (t * c)) * c + lane % c
    ok = (slot < nb) & (slot < count.long()[tri])
    tri, slot = tri[ok], slot[ok]
    other = cand.long()[tri, slot]
    tl = triangles.long()
    own, oth = tl[tri], tl[other]
    keep = (other != tri) & ~(own[:, :, None] == oth[:, None, :]).any(-1).any(-1)
    tri, other, own, oth = tri[keep], other[keep], own[keep], oth[keep]
    hits = []
    for r0 in range(0, tri.shape[0], 1 << 20):
        o, w = oth[r0: r0 + (1 << 20)], own[r0: r0 + (1 << 20)]
        b0, b1 = prev[o[:, 0]], x[o[:, 0]]
        ab0, ac0 = prev[o[:, 1]] - b0, prev[o[:, 2]] - b0
        ab1, ac1 = x[o[:, 1]] - b1, x[o[:, 2]] - b1
        hit = [point_triangle_ccd(prev[w[:, k]] - b0, ab0, ac0, x[w[:, k]] - b1, ab1, ac1,
                                  sc.thr)[0] for k in range(3)]
        hits.append(torch.stack(hit, 1))
    hit = torch.cat(hits) if hits else torch.zeros((0, 3), dtype=torch.bool, device=dev)
    flat = torch.nonzero(hit.reshape(-1)).reshape(-1)
    if stats is not None:
        stats.update(live_lanes=int(tri.shape[0]), contacts=int(flat.shape[0]))
    flat = flat[:cap]
    n = flat.shape[0]
    if n:
        pair, corner = flat // 3, flat % 3
        pt_idx[:n, 0] = own[pair, corner].to(torch.int32)
        pt_idx[:n, 1:] = oth[pair].to(torch.int32)
        pt_mask[:n] = 1.0
    pt_count.fill_(n)
    return pt_idx, pt_mask, pt_count


def tri_ccd(x, prev, triangles, cand, count, flags, lay: TriLayout, sc: Scalars,
            failed: torch.Tensor | None = None):
    """Kernel T17 on CUDA tensors, :func:`tri_ccd_plain` on CPU tensors
    (same arguments and results).  On the card the count stays on the
    device, the kernel does nothing past its first stage when ``flags[0]``
    (the candidate slots T16 filled) is 0, and ``failed`` is required."""
    if kernels.on_cpu(x):
        return tri_ccd_plain(x, prev, triangles, cand, count, flags, lay, sc, failed)
    if failed is None:
        raise ValueError("the CCD kernel needs the failure latch")
    if max(members_of(x), 1) * lay.lanes >= 1 << 31:
        raise ValueError("the CCD kernel takes fewer than 2^31 lanes in all")
    dev = x.device
    kernels.require(dev, x, prev, triangles, cand, count, flags, failed)
    members = kernels.launch_members(x, failed, prev, cand, count, flags)
    lead = x.shape[:-2]  # (B,) for an ensemble: every buffer per member
    i32 = dict(dtype=torch.int32, device=dev)
    cap = lay.cap
    hits = torch.empty(lead + (lay.lanes,), dtype=torch.uint8, device=dev)
    # Each member's block sums, then the members' totals.
    partial = torch.empty(members * (kernels.scan_partials(lay.lanes) + 1), **i32)
    pt_idx = torch.empty(lead + (cap, 4), **i32)
    pt_mask = torch.empty(lead + (cap,), dtype=torch.float32, device=dev)
    pt_count = torch.empty(lead + (1,), **i32)
    err = kernels.lib().pies_tri_ccd(
        x.data_ptr(), prev.data_ptr(), triangles.data_ptr(), cand.data_ptr(),
        count.data_ptr(), flags.data_ptr(), hits.data_ptr(), partial.data_ptr(),
        pt_idx.data_ptr(), pt_mask.data_ptr(), pt_count.data_ptr(), failed.data_ptr(),
        lay.t, lay.nb, lay.chunk, cap, sc.thr, x.shape[-2], members, kernels.stream(),
    )
    kernels.check(err, "tri_ccd")
    tri_ccd.launches += 1
    return pt_idx, pt_mask, pt_count


tri_ccd.launches = 0


def _detect_tri(x, prev, triangles, tri_mask, params: PhysicsParams, config: StepConfig,
                failed, plain: bool, mode: str, emit=None):
    """A per-triangle branch of :func:`detect_point_tri_collisions`."""
    lay = tri_layout(config, triangles.shape[0], mode)
    sc = tri_scalars(params, config)
    overflow = torch.zeros(x.shape[:-2] + (1,), dtype=torch.int32, device=x.device)
    cf, df = (tri_candidates_plain, tri_ccd_plain) if plain else (tri_candidates, tri_ccd)
    cand, count, flags = cf(x, prev, triangles, tri_mask, lay, sc, overflow, failed, emit)
    pt_idx, pt_mask, pt_count = df(x, prev, triangles, cand, count, flags, lay, sc, failed)
    return pt_idx, pt_mask, pt_count, overflow, torch.zeros_like(overflow)


# ---------------------------------------------------------------------------
# edge-edge detection: T16 (cell-list candidates) and T25 (the edge CCD)

EDGES = ((0, 1), (1, 2), (2, 0))  # a triangle's edges, in the JAX order


def edge_ccd_plain(x, prev, triangles, cand, count, flags, cap: int, quirks: bool,
                   failed: torch.Tensor | None = None, emit: torch.Tensor | None = None):
    """Plain twin of kernel T25, the narrowphase of ``detect_edge_edge_
    collisions`` (``broadphase.py:1485-1548``): each (triangle, candidate
    slot) pair whose candidate has a larger id and shares no node, its 3 x 3
    edge combos CCD-tested (``narrowphase.edge_edge_ccd``, relative to the
    first edge's start); the hits compacted combo-major (combo 0 over all
    pairs ascending, then combo 1, ...) into ``cap`` contacts and decoded to
    ``(a, b | c, d)``.  Returns ``(edge_idx i32[cap, 4], edge_mask f32[cap],
    edge_count i32[1], edge_hits i32[1])``, ``edge_hits`` the hits before
    the cap.  Nothing is found when latch slot 0 is set or T16 filled no
    slot.  ``emit`` (f32[T], or None) keeps the pairs whose triangle emits
    (``broadphase.py:1499-1500``).  An ensemble (``x`` f32[B, N, 3], T16's rows, counts and flags
    and the latch per member) runs member by member: every result with the
    member axis."""
    if members_of(x):
        return each_member(lambda xb, pb, cb, kb, gb, fb: edge_ccd_plain(
            xb, pb, triangles, cb, kb, gb, cap, quirks, fb, emit), members_of(x), x, prev, cand,
            count, flags, failed)
    dev = x.device
    edge_idx = torch.zeros((cap, 4), dtype=torch.int32, device=dev)
    edge_mask = torch.zeros(cap, dtype=torch.float32, device=dev)
    edge_count = torch.zeros(1, dtype=torch.int32, device=dev)
    edge_hits = torch.zeros(1, dtype=torch.int32, device=dev)
    if (failed is not None and bool(failed[0])) or int(flags[0]) == 0:
        return edge_idx, edge_mask, edge_count, edge_hits
    t, nb = cand.shape
    pair = torch.arange(t * nb, device=dev)
    tri, slot = pair // nb, pair % nb
    other = cand.reshape(-1).long()
    tl = triangles.long()
    ok = (slot < count.long()[tri]) & (other > tri)
    if emit is not None:
        ok &= emit[tri] > 0
    ok &= ~(tl[tri][:, :, None] == tl[other][:, None, :]).any(-1).any(-1)
    pair, tri, other = pair[ok], tri[ok], other[ok]
    ids = []
    for e1, (i0, i1) in enumerate(EDGES):
        a, b = tl[tri, i0], tl[tri, i1]
        for e2, (j0, j1) in enumerate(EDGES):
            c, d = tl[other, j0], tl[other, j1]
            p0, p1 = prev[a], x[a]
            hit = edge_edge_ccd(_cols(prev[b] - p0), _cols(prev[c] - p0), _cols(prev[d] - p0),
                                _cols(x[b] - p1), _cols(x[c] - p1), _cols(x[d] - p1),
                                quirk=quirks)
            ids.append(pair[hit] * 9 + (e1 * 3 + e2))
    ids = torch.cat(ids) if ids else torch.zeros(0, dtype=torch.int64, device=dev)
    edge_hits.fill_(ids.shape[0])
    ids = ids[:cap]
    n = ids.shape[0]
    if n:
        combo, pr = ids % 9, ids // 9
        e = torch.tensor(EDGES, dtype=torch.int64, device=dev)
        own, oth = tl[pr // nb], tl[cand.reshape(-1).long()[pr]]
        ab = own.gather(1, e[combo // 3])
        cd = oth.gather(1, e[combo % 3])
        edge_idx[:n] = torch.cat([ab, cd], dim=1).to(torch.int32)
        edge_mask[:n] = 1.0
    edge_count.fill_(n)
    return edge_idx, edge_mask, edge_count, edge_hits


def edge_ccd(x, prev, triangles, cand, count, flags, cap: int, quirks: bool,
             failed: torch.Tensor | None = None, emit: torch.Tensor | None = None):
    """Kernel T25 on CUDA tensors, :func:`edge_ccd_plain` on CPU tensors
    (same arguments and results; the counts stay on the device).  On the
    card ``failed`` is required; an ensemble is one launch for all
    members."""
    if kernels.on_cpu(x):
        return edge_ccd_plain(x, prev, triangles, cand, count, flags, cap, quirks, failed,
                              emit)
    if failed is None:
        raise ValueError("the edge CCD kernel needs the failure latch")
    t, nb = cand.shape[-2:]
    if 9 * t * nb >= 1 << 31:  # (a lane index counts one member's pairs)
        raise ValueError("the edge CCD kernel takes fewer than 2^31 lanes a member")
    dev = x.device
    kernels.require(dev, x, prev, triangles, cand, count, flags, failed, emit)
    members = kernels.launch_members(x, failed, prev, cand, count, flags)
    lead = x.shape[:-2]  # (B,) for an ensemble: every buffer per member
    i32 = dict(dtype=torch.int32, device=dev)
    bits = torch.empty(lead + (t * nb,), dtype=torch.int16, device=dev)
    # Each member's block sums of the nine combos, then the members' totals.
    partial = torch.empty(members * (9 * kernels.scan_partials(t * nb) + 1), **i32)
    edge_idx = torch.empty(lead + (cap, 4), **i32)
    edge_mask = torch.empty(lead + (cap,), dtype=torch.float32, device=dev)
    edge_count = torch.empty(lead + (1,), **i32)
    edge_hits = torch.empty(lead + (1,), **i32)
    err = kernels.lib().pies_edge_ccd(
        x.data_ptr(), prev.data_ptr(), triangles.data_ptr(), cand.data_ptr(),
        count.data_ptr(), flags.data_ptr(), bits.data_ptr(), partial.data_ptr(),
        edge_idx.data_ptr(), edge_mask.data_ptr(), edge_count.data_ptr(),
        edge_hits.data_ptr(), failed.data_ptr(), kernels.ptr(emit), t, nb, cap, int(quirks),
        x.shape[-2], members, kernels.stream())
    kernels.check(err, "edge_ccd")
    edge_ccd.launches += 1
    return edge_idx, edge_mask, edge_count, edge_hits


edge_ccd.launches = 0


def detect_edge_edge_collisions(x, prev, triangles, tri_mask, params: PhysicsParams,
                                config: StepConfig, overflow: torch.Tensor,
                                failed: torch.Tensor | None = None, plain: bool = False,
                                emit: torch.Tensor | None = None):
    """Port of ``detect_edge_edge_collisions`` (``broadphase.py:1450-1548``):
    the cell-list candidates (T16 in ``"celllist"`` mode, whatever branch
    the point-triangle detection takes, in ``broadphase_cell`` units), their
    latches ORed into ``overflow``, then T25 (with the emit mask ``emit``,
    f32[T] or None, on its pairs).  Returns ``(edge_idx,
    edge_mask, edge_count, edge_hits)``, each with the member axis for an
    ensemble's ``x`` f32[B, N, 3] (T16 and T25 take it)."""
    lay = tri_layout(config, triangles.shape[0], "celllist")
    sc = scalars(params)
    cf, ef = (tri_candidates_plain, edge_ccd_plain) if plain else (tri_candidates, edge_ccd)
    cand, count, flags = cf(x, prev, triangles, tri_mask, lay, sc, overflow, failed)
    return ef(x, prev, triangles, cand, count, flags, config.budget.max_edge_contacts,
              config.reference_quirks, failed, emit)


def detect_node_node_pairs(x, radius, node_mask, params: PhysicsParams, config: StepConfig,
                           failed, plain: bool = False, emit: torch.Tensor | None = None):
    """Port of ``detect_node_node_pairs`` (``broadphase.py:1975-2015``): the
    i-major pair prefix of T20, built afresh in a new cache (PD detects
    every substep; the PBD cache ``state.nn`` is not touched), of which the
    first ``min(count, max_node_node_contacts)`` pairs are the contacts
    (``batches.node_pairs_of``); with ``emit`` (f32[N]) only the pairs
    whose first node emits (the domain decomposition's owned nodes).
    Returns the cache, one per member for an ensemble's ``x`` f32[B, N, 3]
    (every field with the member axis)."""
    nn = empty_node_pair_cache(x.shape[-2], config.budget.max_candidates_per_node, x.device)
    if members_of(x):
        nn = stack_members([nn] * members_of(x))
    (node_pairs_plain if plain else node_pairs)(x, radius, node_mask, nn, params, config,
                                                failed, emit)
    return nn


# ---------------------------------------------------------------------------
# The PBD node-node response: T20 (node grid and pair cache), T21 (response)

# World-units displacement bound of the node-pair cache
# (``pies_tpu/collision/broadphase.py:2015``): the AABB padding of 0.5
# keeps a touching pair's padded boxes overlapping while each node drifts
# up to 0.5 per axis from where the grid was built; margin for roundoff.
NN_CACHE_SLACK = float(np.float32(0.497))
NODE_RANGE_CAP = 50  # per-axis cells of a node's box (broadphase.py:1933)
NODE_TABLE_MAX = 1 << 22
NODE_MAX_CELLS = 64  # kMaxNodeCells of kernels/csrc/node_pairs.cu
NODE_MAX_BUDGET = 32  # a lane per candidate slot
NODE_MAX_HEAD = 64  # kMaxHead: the largest max_entries_per_cell T20 takes
NODE_SMALL_BUCKET = 32  # kSmallBucket: larger buckets are ordered by a warp


def node_table_size(n: int, config: StepConfig) -> int:
    """Slots of the node grid: ``min(table_size_for(n·cells, 1), 2^22)``."""
    return min(table_size_for(n * config.budget.max_cells_per_node, 1.0), NODE_TABLE_MAX)


def node_pair_candidates(x: torch.Tensor, radius: torch.Tensor, node_mask: torch.Tensor,
                         params: PhysicsParams, config: StepConfig, emit=None):
    """Port of ``_node_pair_candidates`` (``broadphase.py:1903-1972``): every
    live node's AABB padded by 0.5 (``NodeCompRange``, ``Solver.cpp:877-901``)
    in ``grid_spacing`` cells, its cells (range cap 50), the grid, up to
    ``max_candidates_per_node`` candidates per node in query-cell order
    (``max_entries_per_cell`` per bucket), each row sorted and deduplicated.
    Returns ``(cand i32[N, B], ok bool[N, B])``, ``ok`` marking unordered
    pairs (``cand > i``) of live nodes, whose i emits where ``emit`` (f32[N])
    is given (``broadphase.py:1966-1971``)."""
    budget = config.budget
    n = x.shape[0]
    live = node_mask > 0
    gs = params.grid_spacing
    r_grid = _div(radius + 0.5, gs)
    center = _div(x, gs)
    coords, valid, _ = aabb_cell_slots(center - r_grid[:, None], center + r_grid[:, None],
                                       budget.max_cells_per_node, NODE_RANGE_CAP)
    valid = valid & live[:, None]
    grid = build_grid(coords, valid, node_table_size(n, config))
    cand, cand_valid, _ = gather_candidates(grid, coords, valid, budget.max_entries_per_cell,
                                            budget.max_candidates_per_node)
    sentinel = 2**31 - 1
    cand_sorted = torch.sort(torch.where(cand_valid, cand, sentinel), dim=-1).values
    first = torch.ones_like(cand_valid)
    first[:, 1:] = cand_sorted[:, 1:] != cand_sorted[:, :-1]
    cand_valid = first & (cand_sorted != sentinel)
    cand = torch.clamp_max(cand_sorted, n - 1)
    i_idx = torch.arange(n, dtype=torch.int32, device=x.device)[:, None]
    ok = cand_valid & (cand > i_idx) & live[:, None] & live[cand.long()]
    if emit is not None:
        ok &= (emit > 0)[:, None]
    return cand.to(torch.int32), ok


def node_pair_prefix(x, radius, node_mask, params: PhysicsParams, config: StepConfig,
                     emit=None):
    """Port of ``_node_pair_prefix`` (``broadphase.py:2018-2032``): the
    unordered pairs packed to a valid prefix in stable i-major order.
    Returns ``(pi i32[NB], pj i32[NB], count)``; the tail holds the invalid
    slots in order."""
    cand, ok = node_pair_candidates(x, radius, node_mask, params, config, emit)
    n, bw = cand.shape
    ok_f = ok.reshape(-1)
    order = torch.sort((~ok_f).to(torch.int32), stable=True).indices
    i_f = torch.arange(n, dtype=torch.int32, device=x.device).repeat_interleave(bw)
    return i_f[order], cand.reshape(-1)[order], int(ok_f.sum())


def pair_terms(x, vel, radius, inv_mass, pi, pj, params: PhysicsParams):
    """The response of each pair ``(pi[k], pj[k])`` (``_pair_response_acc``,
    ``broadphase.py:2035-2112``, ``Solver.cpp:95-129``): the 0.85-relaxed
    mass-weighted push of a touching pair and its friction impulse.
    Returns ``(vals_i f32[P, 6], vals_j f32[P, 6], touching bool[P])``, each
    side's ``(dx | dv)``."""
    a_i, b_i = pi.long(), pj.long()
    df = [x[b_i, d] - x[a_i, d] for d in range(3)]
    rl = [vel[b_i, d] - vel[a_i, d] for d in range(3)]
    dist = torch.sqrt(df[0] * df[0] + df[1] * df[1] + df[2] * df[2])
    disp = (radius[a_i] + radius[b_i]) - dist
    touching = disp > 0.0
    inv_d = 1.0 / torch.clamp_min(dist, 1e-20)
    ndeg = dist > 1e-5
    dirs = [torch.where(ndeg, df[d] * inv_d, 1.0 if d == 0 else 0.0) for d in range(3)]
    im_i, im_j = inv_mass[a_i], inv_mass[b_i]
    w_sum = torch.clamp_min(im_i + im_j, 1e-20)
    amp = torch.where(touching, 0.85 * disp, 0.0)
    si = -amp * (im_i / w_sum)
    sj = amp * (im_j / w_sum)
    vdotn = rl[0] * dirs[0] + rl[1] * dirs[1] + rl[2] * dirs[2]
    pp = [rl[d] - vdotn * dirs[d] for d in range(3)]
    fr = torch.where(torch.sqrt(pp[0] * pp[0] + pp[1] * pp[1] + pp[2] * pp[2])
                     < params.static_friction_threshold, 1.0, params.friction)
    f_amp = torch.where(touching, fr, 0.0)
    fi = -f_amp * (im_i / w_sum)
    fj = f_amp * (im_j / w_sum)
    side = lambda s, f: torch.stack([s * dirs[0], s * dirs[1], s * dirs[2],
                                     f * pp[0], f * pp[1], f * pp[2]], dim=1)
    return side(si, fi), side(sj, fj), touching


def _response_incidence(pi, pj, count: int, row_off, inc_start, inc_pair) -> Incidence:
    """Node n's entries of ``concat(vals_i, vals_j)`` (``count`` rows each)
    from a pair incidence (``state.pair_incidence``): its pairs as i, then
    ``count +`` its pairs as j, ascending."""
    n, dev = row_off.shape[0] - 1, pi.device
    ci = (row_off[1:] - row_off[:-1]).long()
    cj = (inc_start[1:] - inc_start[:-1]).long()
    start = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(ci + cj, 0)
    entries = torch.zeros(2 * count, dtype=torch.int64, device=dev)
    k = torch.arange(count, dtype=torch.int64, device=dev)
    node_i = pi[:count].long()
    entries[start[node_i] + k - row_off[node_i].long()] = k
    kj = inc_pair[:count].long()
    node_j = pj[kj].long()
    entries[start[node_j] + ci[node_j] + k - inc_start[node_j].long()] = count + kj
    return Incidence(row_start=start.to(torch.int32), entries=entries.to(torch.int32),
                     nodes=torch.zeros(0, dtype=torch.int32, device=dev), cap=2 * count)


def pair_response_acc(x, vel, radius, inv_mass, pi, pj, count: int,
                      params: PhysicsParams) -> torch.Tensor:
    """Port of ``_pair_response_acc``: the ``[N, 6]`` (dx | dv) sum over
    the rows ``concat(pi, pj)`` of the pairs ``k < count``, per node in the
    JAX scatter's order."""
    pi, pj = pi[:count], pj[:count]
    inc = _response_incidence(pi, pj, count, *pair_incidence(pi, pj, count, x.shape[0]))
    vi, vj, _ = pair_terms(x, vel, radius, inv_mass, pi, pj, params)
    return csr_sum(inc, torch.cat([vi, vj]))


def node_pairs_plain(x, radius, node_mask, nn, params: PhysicsParams, config: StepConfig,
                     failed, emit: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of kernel T20, in place on the cache ``nn``: the drift test
    (``max|x − ref| > NN_CACHE_SLACK``, or a stale cache), then on a rebuild
    the pair prefix of :func:`node_pair_prefix`, ``ref = x``, ``fresh = 1``
    and the incidence of :func:`state.pair_incidence`; ``emit`` as in
    :func:`node_pair_candidates`.  Returns the rebuild flag i32[1] (also
    ``nn.rebuilt``); nothing happens when latch slot 0 is set.  An ensemble
    (``x`` f32[B, N, 3], its cache and latch per member) runs member by
    member."""
    if members_of(x):
        each_member(lambda xb, rb, mb, cb, fb: node_pairs_plain(xb, rb, mb, cb, params, config,
                                                                fb, emit),
                    members_of(x), x, radius, node_mask, nn, failed)
        return nn.rebuilt
    drift = torch.max(torch.abs(x - nn.ref))
    due = (int(failed[0]) == 0
           and (int(nn.fresh[0]) == 0 or bool(drift > NN_CACHE_SLACK)))
    nn.rebuilt.fill_(int(due))
    if due:
        pi, pj, count = node_pair_prefix(x, radius, node_mask, params, config, emit)
        n = x.shape[0]
        ro, ist, ip = pair_incidence(pi, pj, count, n)
        nn.pi[:count] = pi[:count]
        nn.pj[:count] = pj[:count]
        nn.count.fill_(count)
        nn.ref.copy_(x)
        nn.fresh.fill_(1)
        nn.row_off.copy_(ro)
        nn.inc_start.copy_(ist)
        nn.inc_pair[:count] = ip[:count]
    return nn.rebuilt


def node_scratch(n: int, config: StepConfig, device, members: int = 1) -> dict[str, torch.Tensor]:
    """The device scratch of T20 for ``n`` nodes a member, in one int32
    buffer: each array holds ``members`` rows of a member's size (the
    kernel's ``Np::member``), the scans' partials one row per member of the
    wider scan's."""
    h = node_table_size(n, config)
    s, bw = config.budget.max_cells_per_node, config.budget.max_candidates_per_node
    sizes = dict(count_h=h, cursor=h, start=h + 1, partial=kernels.scan_partials(max(h, 2 * n)),
                 entries=n * s, rows=n * bw, cnt2=2 * n, off2=2 * n + 1, jcur=n, flags=8,
                 big=1 + n * s // (NODE_SMALL_BUCKET + 1))
    buf = torch.empty(members * sum(sizes.values()), dtype=torch.int32, device=device)
    out, at = {}, 0
    for name, size in sizes.items():
        out[name] = buf[at: at + members * size]
        at += members * size
    return out


def node_pairs(x, radius, node_mask, nn, params: PhysicsParams, config: StepConfig,
               failed, emit: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel T20 on a CUDA tensor (the cache updated on the device, the
    rebuild decided there), :func:`node_pairs_plain` on a CPU tensor.
    Returns the rebuild flag i32[1] (i32[B, 1] for an ensemble, one launch
    for all members)."""
    if kernels.on_cpu(x):
        return node_pairs_plain(x, radius, node_mask, nn, params, config, failed, emit)
    b = config.budget
    if (b.max_candidates_per_node > NODE_MAX_BUDGET or b.max_cells_per_node > NODE_MAX_CELLS
            or b.max_entries_per_cell > NODE_MAX_HEAD):
        raise ValueError(f"T20 takes at most {NODE_MAX_BUDGET} candidates and"
                         f" {NODE_MAX_CELLS} cells per node, {NODE_MAX_HEAD} entries per cell")
    n = x.shape[-2]
    cache = [getattr(nn, f.name) for f in dataclasses.fields(nn)]
    members = kernels.launch_members(x, failed, radius, node_mask, *cache)
    if nn.pi.shape[-1] != n * b.max_candidates_per_node or nn.ref.shape[-2] != n:
        raise ValueError("the node-pair cache does not match the nodes and the budget")
    sc = node_scratch(n, config, x.device, members)
    kernels.require(x.device, x, radius, node_mask, failed, emit, *cache)
    err = kernels.lib().pies_node_pairs(
        x.data_ptr(), radius.data_ptr(), node_mask.data_ptr(), *(t.data_ptr() for t in cache),
        *(sc[k].data_ptr() for k in ("count_h", "cursor", "start", "partial", "entries", "rows",
                                      "cnt2", "off2", "jcur", "flags", "big")),
        failed.data_ptr(), kernels.ptr(emit), n, b.max_cells_per_node, b.max_entries_per_cell,
        b.max_candidates_per_node, node_table_size(n, config), params.grid_spacing,
        NN_CACHE_SLACK, members, kernels.stream())
    kernels.check(err, "node_pairs")
    node_pairs.launches += 1
    return nn.rebuilt


node_pairs.launches = 0


def node_response_plain(x, vel, radius, inv_mass, node_mask, nn, params: PhysicsParams,
                        failed):
    """Plain twin of kernel T21: ``(x + dx·live, vel + dv·live, touching
    i32[1])`` from the cached pairs (:func:`pair_terms` summed per node over
    the cache's incidence).  New tensors; with latch slot 0 set the inputs
    come back as they are.  An ensemble (``x`` f32[B, N, 3], its cache and
    latch per member) runs member by member; touching i32[B, 1]."""
    if members_of(x):
        return each_member(lambda xb, vb, rb, ib, mb, cb, fb: node_response_plain(
            xb, vb, rb, ib, mb, cb, params, fb), members_of(x), x, vel, radius, inv_mass,
            node_mask, nn, failed)
    touching = torch.zeros(1, dtype=torch.int32, device=x.device)
    if int(failed[0]) != 0:
        return x, vel, touching
    count = int(nn.count[0])
    vi, vj, tch = pair_terms(x, vel, radius, inv_mass, nn.pi[:count], nn.pj[:count], params)
    inc = _response_incidence(nn.pi, nn.pj, count, nn.row_off, nn.inc_start, nn.inc_pair)
    acc = csr_sum(inc, torch.cat([vi, vj]))
    live = (node_mask > 0).to(x.dtype)[:, None]
    touching[0] = int(tch.sum())
    return x + acc[:, :3] * live, vel + acc[:, 3:] * live, touching


def node_response(x, vel, radius, inv_mass, node_mask, nn, params: PhysicsParams, failed):
    """Kernel T21 on a CUDA tensor, :func:`node_response_plain` on a CPU
    tensor.  On the card the outputs are new buffers and the touching count
    stays on the device (i32[B, 1] for an ensemble, one launch for all
    members; a latched member's outputs are left unwritten and its count
    is 0)."""
    if kernels.on_cpu(x):
        return node_response_plain(x, vel, radius, inv_mass, node_mask, nn, params, failed)
    cache = (nn.pi, nn.pj, nn.row_off, nn.inc_start, nn.inc_pair)
    members = kernels.launch_members(x, failed, vel, radius, inv_mass, node_mask, *cache)
    x_out, vel_out = torch.empty_like(x), torch.empty_like(vel)
    touching = torch.empty(x.shape[:-2] + (1,), dtype=torch.int32, device=x.device)
    kernels.require(x.device, x, vel, radius, inv_mass, node_mask, *cache, x_out, vel_out,
                    touching, failed)
    err = kernels.lib().pies_node_response(
        x.data_ptr(), vel.data_ptr(), radius.data_ptr(), inv_mass.data_ptr(),
        node_mask.data_ptr(), nn.pi.data_ptr(), nn.pj.data_ptr(), nn.row_off.data_ptr(),
        nn.inc_start.data_ptr(), nn.inc_pair.data_ptr(), x_out.data_ptr(), vel_out.data_ptr(),
        touching.data_ptr(), x.shape[-2], nn.pi.shape[-1], params.friction,
        params.static_friction_threshold, failed.data_ptr(), members, kernels.stream())
    kernels.check(err, "node_response")
    node_response.launches += 1
    return x_out, vel_out, touching


node_response.launches = 0


def pbd_node_node_response(state, x, vel, params: PhysicsParams, config: StepConfig,
                           cache=None, plain: bool = False):
    """Port of ``pbd_node_node_response`` (``broadphase.py:2115-2187``): the
    node-node push and friction impulses over the pair cache ``cache``
    (``state.nn``): T20 refreshes it when some node drifted past the slack,
    T21 applies the response.  Without a cache (the JAX package's uncached
    form) an empty one stands in, so T20 rebuilds the pairs on every call.  Returns
    ``(x, vel, touching i32[1], rebuilt i32[1])``; the width ladder of the
    JAX package is not ported: the kernels run over the device's count.  An
    ensemble (``x`` f32[B, N, 3]) keeps a cache per member, each rebuilt on
    its own member's drift, as ``vmap`` selects the JAX package's
    ``lax.cond(rebuild, build, keep)`` per member; the counts are i32[B,
    1]."""
    failed = state.sim_failed
    args = (state.radius, state.inv_mass, state.node_mask)
    if cache is None:
        cache = empty_node_pair_cache(x.shape[-2], config.budget.max_candidates_per_node,
                                      x.device)
        if members_of(x):
            cache = stack_members([cache] * members_of(x))
    pairs, respond = ((node_pairs_plain, node_response_plain) if plain
                      else (node_pairs, node_response))
    rebuilt = pairs(x, state.radius, state.node_mask, cache, params, config, failed)
    x, vel, touching = respond(x, vel, *args, cache, params, failed)
    return x, vel, touching, rebuilt


# ---------------------------------------------------------------------------
# candidate occupancy and the oversize counts: kernel T29

OCC_MODES = ("bodies", "allpairs", "celllist")
# T29's result words.
OCC_WORDS = ("count_max", "count_sum", "live_rows", "oversize", "latching")
OCC_TWIN_ROWS = 1 << 12  # all-pairs rows the twin tests at a time


@dataclass(frozen=True)
class OccupancyLayout:
    """The branch of ``candidate_occupancy`` (``broadphase.py:1183-1253``)
    a scene of ``t`` triangle rows takes: ``k`` rows of ``e`` triangles
    (bodies) or of one, the query's ``cells_cap`` cells and
    ``entries_cap`` entries a bucket, the candidate ``budget`` and a grid of
    ``h`` slots (0 for all-pairs)."""

    mode: str
    t: int
    k: int
    e: int
    cells_cap: int
    entries_cap: int
    budget: int
    h: int


def occupancy_layout(config: StepConfig, n_tris: int) -> OccupancyLayout:
    """The JAX package's three branches in its order: a body stride > 1
    (the packed-body grid), at most ``allpairs_broadphase_max`` triangles
    (all-pairs), else the cell list.  As there, a scene whose detection runs
    the super-body branch is counted by the cell list."""
    b = config.budget
    caps = dict(cells_cap=b.max_cells_per_tri, entries_cap=b.max_entries_per_cell)
    if b.body_stride > 1:
        e = b.body_stride
        k = n_tris // e
        return OccupancyLayout("bodies", n_tris, k, e, budget=b.max_candidates_per_body,
                               h=table_size_for(2 * k), **caps)
    if n_tris <= config.allpairs_broadphase_max:
        return OccupancyLayout("allpairs", n_tris, n_tris, 1, budget=b.max_narrow_candidates,
                               h=0, **caps)
    return OccupancyLayout("celllist", n_tris, n_tris, 1, budget=b.max_candidates_per_tri,
                           h=table_size_for(2 * n_tris), **caps)


def occupancy_plain(x, prev, triangles, tri_mask, lay: OccupancyLayout,
                    sc: Scalars) -> torch.Tensor:
    """Plain twin of kernel T29: ``i32[5]``, the words ``OCC_WORDS``.  Each
    row's candidate count is what the branch's front end would gather: the
    grid modes' query total (entries capped per bucket) capped at the budget,
    all-pairs' swept-box overlaps with the margin between live rows other
    than itself (``broadphase.py:1214-1236``).  Then the largest count, the
    live rows' sum and number, and the live rows whose box spans more than
    one cell and more than 2 − margin cells (``diagnostics.py:151-169``)."""
    dev = x.device
    lo, hi = tri_swept_aabb(x, prev, triangles, sc.cell)
    live = tri_mask > 0
    if lay.mode == "bodies":  # a body's box over its live triangles, 0 when dead
        n, big = lay.k * lay.e, 3.0e38
        lo = torch.where(live[:, None], lo, big)[:n].view(lay.k, lay.e, 3).amin(1)
        hi = torch.where(live[:, None], hi, -big)[:n].view(lay.k, lay.e, 3).amax(1)
        live = live[:n].view(lay.k, lay.e).any(1)
        lo = torch.where(live[:, None], lo, 0.0)
        hi = torch.where(live[:, None], hi, 0.0)
    ext = (hi - lo).amax(-1)
    if lay.mode == "allpairs":
        counts = torch.zeros(lay.k, dtype=torch.int64, device=dev)
        cols = torch.arange(lay.k, device=dev)
        for r0 in range(0, lay.k, OCC_TWIN_ROWS):
            rows = slice(r0, min(r0 + OCC_TWIN_ROWS, lay.k))
            ov = ((lo[None] <= hi[rows, None] + sc.margin)
                  & (hi[None] >= lo[rows, None] - sc.margin)).all(-1)
            ov &= live[rows, None] & live[None, :] & (cols[None, :] != cols[rows, None])
            counts[rows] = ov.sum(1)
    else:
        ins_coords, ins_valid = _insertion_slots(lo, hi, live)
        grid = build_grid(ins_coords, ins_valid, lay.h)
        q_coords, q_valid, _ = aabb_cell_slots(lo - 1.0, hi, lay.cells_cap, QUERY_RANGE_CAP)
        _, _, total, _ = query_buckets(grid, q_coords, q_valid & live[:, None],
                                       lay.entries_cap)
        counts = total.clamp_max(lay.budget).long()
    words = [counts.max() if counts.numel() else counts.new_zeros(()),
             (counts * live).sum(), live.sum(), ((ext > 1.0) & live).sum(),
             ((ext > sc.size_limit) & live).sum()]
    return torch.stack(words).to(torch.int32)


def occupancy(x, prev, triangles, tri_mask, lay: OccupancyLayout, sc: Scalars) -> torch.Tensor:
    """Kernel T29 on CUDA tensors, :func:`occupancy_plain` on CPU tensors
    (same arguments and result, ``i32[5]`` on the device)."""
    if kernels.on_cpu(x):
        return occupancy_plain(x, prev, triangles, tri_mask, lay, sc)
    dev = x.device
    kernels.require(dev, x, prev, triangles, tri_mask)
    out = torch.zeros(len(OCC_WORDS), dtype=torch.int32, device=dev)
    if lay.t == 0:
        return out
    bounds = torch.empty((2, lay.t + lay.k, 3), dtype=torch.float32, device=dev)
    table = torch.empty(max(lay.h, 1), dtype=torch.int32, device=dev)
    err = kernels.lib().pies_occupancy(
        x.data_ptr(), prev.data_ptr(), triangles.data_ptr(), tri_mask.data_ptr(),
        bounds.data_ptr(), table.data_ptr(), out.data_ptr(), OCC_MODES.index(lay.mode),
        lay.t, lay.k, lay.e, lay.cells_cap, lay.entries_cap, lay.budget, lay.h, sc.cell,
        sc.margin, sc.size_limit, kernels.stream())
    kernels.check(err, "occupancy")
    occupancy.launches += 1
    return out


occupancy.launches = 0


def occupancy_result(words, config: StepConfig, n_tris: int):
    """``(count_max, count_mean, budget)`` of ``candidate_occupancy`` from
    T29's words (host ints): the mean is the float32 sum over the float32
    live-row count, as the JAX package divides."""
    cmax, csum, live = (int(w) for w in words[:3])
    mean = np.float32(csum) / np.float32(max(live, 1))
    return cmax, float(mean), occupancy_layout(config, n_tris).budget


def candidate_occupancy(x, prev, triangles, tri_mask, params: PhysicsParams,
                        config: StepConfig):
    """Candidate-buffer occupancy of the active broadphase branch at the
    given state (``pies_tpu/collision/broadphase.py:1183-1253``):
    ``(count_max, count_mean, budget)`` as host numbers.  Static candidate
    buffers drop overflow gracefully, so a scene can drift toward the budget
    cliff unseen until contacts go missing; ``count_max / budget > 1`` reads
    as the overflow factor."""
    lay = occupancy_layout(config, triangles.shape[0])
    words = occupancy(x, prev, triangles, tri_mask, lay, scalars(params))
    return occupancy_result(words.tolist(), config, triangles.shape[0])
