"""Uniform-grid broadphase with a direct-address bucket table (port of
``pies_tpu/collision/grid.py:33-187,254-411``), in plain PyTorch.

Every item expands to (cell, item) entries; entries are keyed by the
reference's cell hash (``SpatialHash.h:28-34``) masked into a power-of-two
table and sorted stably by slot, so each bucket lists its entries in entry
order (``item·S + slot``).  A bucket is a (start, count) pair; a query walks
its cells in order and takes at most ``per_cell_cap`` entries of each.

These are the plain twins of the bucket stages of kernels T5, T14 and T16
(``kernels/csrc/body_broadphase.cu``, ``super_broadphase.cu``,
``tri_candidates.cu``).  The JAX package's TPU workarounds
(the packed one-gather table, the width tiers, ``_lookup_i32``, ``_idiv``,
``_rank_and_prev``) are not ported; their results are kept: counts saturate
as the packed table's 7-bit field does, so a bucket of 127 or more entries
latches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_M32 = 0xFFFFFFFF
_HASH = (92837111, 689287499, 283923481)
PACKED_MAX_ENTRIES = 1 << 24  # start field width of the JAX package's table
SATURATED = 127  # the packed table's count field saturates here
HARD_CAP = 1000  # the reference's bucket-explosion latch (Solver.cpp:741-755)


def table_size_for(num_items: int, load_factor: float = 0.5) -> int:
    """Power-of-two table size for the given load factor."""
    need = max(16, int(num_items / max(load_factor, 1e-3)))
    return 1 << (need - 1).bit_length()


def cell_hash(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor) -> torch.Tensor:
    """``(x·92837111) ^ (y·689287499) ^ (z·283923481)`` in uint32 arithmetic
    (int32 cells reinterpreted as two's complement, products wrapping), as
    int64 values in ``[0, 2^32)``."""
    out = None
    for c, k in zip((cx, cy, cz), _HASH):
        u = ((c.to(torch.int64) & _M32) * k) & _M32
        out = u if out is None else out ^ u
    return out


def aabb_cell_slots(lo: torch.Tensor, hi: torch.Tensor, cells_cap: int, range_cap: int):
    """The grid cells covered by each box (grid units) in ``cells_cap``
    slots, x-major (``sweptTriRange``, ``Solver.cpp:639-677``): a range
    longer than ``range_cap`` on any axis is empty.  Returns ``(coords
    i32[M, S, 3], valid bool[M, S], overflow bool[M])``."""
    base = torch.floor(lo).to(torch.int32)
    length = (torch.ceil(hi) - torch.floor(lo)).to(torch.int32).clamp_min(1)
    in_cap = (length <= range_cap).all(dim=-1)
    length = torch.where(in_cap[:, None], length, 0)
    total = length[:, 0] * length[:, 1] * length[:, 2]
    s = torch.arange(cells_cap, dtype=torch.int32, device=lo.device)[None, :]
    lyz = (length[:, 1] * length[:, 2]).clamp_min(1)[:, None]
    lz = length[:, 2].clamp_min(1)[:, None]
    dx = torch.div(s, lyz, rounding_mode="floor")
    rem = s - dx * lyz
    dy = torch.div(rem, lz, rounding_mode="floor")
    dz = rem - dy * lz
    valid = s < torch.clamp_max(total, cells_cap)[:, None]
    coords = base[:, None, :] + torch.stack([dx, dy, dz], dim=-1)
    return coords, valid, total > cells_cap


@dataclass
class HashGrid:
    """Entries sorted by table slot, and the per-slot (start, count)."""

    sorted_entries: torch.Tensor  # i32[E] entry index item·S + slot
    start: torch.Tensor  # i32[H] first sorted entry of each slot
    count: torch.Tensor  # i32[H]
    slots_per_item: int

    @property
    def num_slots(self) -> int:
        return self.start.shape[0]

    @property
    def sorted_items(self) -> torch.Tensor:
        return torch.div(self.sorted_entries, self.slots_per_item, rounding_mode="floor")


def table_slots(coords: torch.Tensor, valid: torch.Tensor, h: int) -> torch.Tensor:
    """Table slot of each cell, ``h`` for invalid cells."""
    slot = cell_hash(coords[..., 0], coords[..., 1], coords[..., 2]) & (h - 1)
    return torch.where(valid, slot, h)


def build_grid(cell_coords: torch.Tensor, valid: torch.Tensor, table_size: int) -> HashGrid:
    """Sort all (cell, item) entries stably by table slot and count each
    slot.  ``cell_coords`` i32[M, S, 3], ``valid`` bool[M, S]."""
    m, s, _ = cell_coords.shape
    h = table_size
    slot = table_slots(cell_coords, valid, h).reshape(-1)
    order = torch.sort(slot, stable=True).indices
    count = torch.bincount(slot, minlength=h + 1)[:h].to(torch.int32)
    start = (torch.cumsum(count, 0) - count).to(torch.int32)
    return HashGrid(sorted_entries=order.to(torch.int32), start=start, count=count,
                    slots_per_item=s)


def query_buckets(grid: HashGrid, query_coords: torch.Tensor, query_valid: torch.Tensor,
                  per_cell_cap: int, hard_cap: int = HARD_CAP):
    """Bucket (start, count) of every queried cell.  Counts are capped at
    ``per_cell_cap``; a row overflows when one of its buckets holds 127 or
    more entries (the packed table's saturation; ``hard_cap`` when there are
    2^24 entries or more) or its capped total exceeds ``hard_cap``.

    Returns ``(start i32[M,S], offsets i32[M,S] inclusive, total i32[M],
    overflow bool[M])``."""
    h = grid.num_slots
    slot = table_slots(query_coords, query_valid, h)
    pad = torch.zeros(1, dtype=torch.int32, device=slot.device)
    start = torch.cat([grid.start, pad])[slot]
    count = torch.cat([grid.count, pad])[slot]
    if grid.sorted_entries.shape[0] < PACKED_MAX_ENTRIES:
        cell_over = count >= SATURATED
    else:
        cell_over = count > hard_cap
    count = torch.clamp_max(count, per_cell_cap)
    offsets = torch.cumsum(count, dim=-1, dtype=torch.int32)
    total = offsets[:, -1]
    return start, offsets, total, cell_over.any(dim=-1) | (total > hard_cap)


def gather_entries(grid: HashGrid, start: torch.Tensor, offsets: torch.Tensor,
                   total: torch.Tensor, budget: int):
    """Up to ``budget`` candidate items per row, the queried cells' entries
    back to back in query order.  Returns ``(candidates i32[M, B],
    valid bool[M, B])``; invalid slots hold 0."""
    m, s = start.shape
    b = torch.arange(budget, dtype=torch.int32, device=start.device).expand(m, budget)
    # Slot b falls in cell c = #{s : offsets[s] <= b}.
    c = torch.searchsorted(offsets.contiguous(), b.contiguous(), right=True)
    prev = torch.where(c > 0, torch.gather(offsets, 1, (c - 1).clamp_min(0)), 0)
    st = torch.gather(torch.cat([start, torch.zeros_like(start[:, :1])], 1), 1, c)
    valid = b < torch.clamp_max(total, budget)[:, None]
    entry = torch.where(valid, st + b - prev, 0).long()
    cand = torch.where(valid, grid.sorted_items[entry.clamp_max(grid.sorted_entries.shape[0] - 1)], 0)
    return cand.to(torch.int32), valid


def gather_candidates(grid: HashGrid, query_coords: torch.Tensor, query_valid: torch.Tensor,
                      per_cell_cap: int, budget: int, hard_cap: int = HARD_CAP):
    """Up to ``budget`` candidate items per query row: :func:`query_buckets`
    then :func:`gather_entries`.  Entries past ``per_cell_cap`` in a bucket
    and past ``budget`` in a row are dropped; a row latches as
    :func:`query_buckets` says (the reference's ``_simFailed``,
    ``Solver.cpp:741-755``).  Returns ``(candidates i32[M, budget], valid
    bool[M, budget], overflow bool[M])``."""
    start, offsets, total, overflow = query_buckets(grid, query_coords, query_valid,
                                                    per_cell_cap, hard_cap)
    cand, valid = gather_entries(grid, start, offsets, total, budget)
    return cand, valid, overflow
