"""Kernel T30: the halo exchange of the domain decomposition
(``pies_tpu/parallel/domain.py:581-609``), each wrapper beside its plain
twin, and the gather of the slabs' contact lists into the flat scene.

D slabs of L owned nodes (``f32[D, L, k]``) have views of V = L + 2B slots
(``f32[D, V, k]``): B halo slots from the left neighbour's tail, the owned
slots, B from the right neighbour's head.  Across ranks a device holds D
of the domain's slabs, and refresh and reduce take the rank's two outer
bands, ``left`` and ``right`` f32[B, k], which the neighbouring ranks sent
(:mod:`.ranks` moves them); without a band, slab 0's left and slab D−1's
right halo are zero, as ``ppermute`` with no source gives.  A CUDA tensor
launches ``csrc/halo.cu``; a CPU tensor takes the twin.  Each wrapper
counts its launches on its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..ops.math3d import ieee_div as _div
from ..solver.assembly import block_partials

SUM, APPLY, AVERAGE = 0, 1, 2  # the reduce's modes (csrc/halo.cu)
SENTINEL = 2**31 - 1


def refresh_plain(own: torch.Tensor, halo: int, zero_halo: bool = False, left=None,
                  right=None) -> torch.Tensor:
    """Plain twin of T30's refresh: owned ``f32[D, L]`` or ``f32[D, L, k]``
    to the views ``f32[D, L + 2B, ...]`` (``_halo_refresh``), the halos
    zero with ``zero_halo`` (the owned values embedded); ``left`` (the left
    rank's last slab's tail) and ``right`` (the right rank's first slab's
    head), f32[B, ...] each, fill slab 0's left and slab D−1's right halo,
    zero where None."""
    z = torch.zeros_like(own[:1, :halo])
    if zero_halo:
        lo = hi = torch.zeros_like(own[:, :halo])
    else:
        lo = torch.cat([z if left is None else left[None], own[:-1, own.shape[1] - halo:]])
        hi = torch.cat([own[1:, :halo], z if right is None else right[None]])
    return torch.cat([lo, own, hi], dim=1)


def refresh(own: torch.Tensor, halo: int, zero_halo: bool = False, left=None,
            right=None) -> torch.Tensor:
    """T30's refresh on a CUDA tensor, :func:`refresh_plain` on a CPU one."""
    if kernels.on_cpu(own):
        return refresh_plain(own, halo, zero_halo, left, right)
    d, l = own.shape[:2]
    k = own.shape[2] if own.dim() == 3 else 1
    kernels.require(own.device, own, left, right)
    _check_bands(halo, k, left, right)
    view = torch.empty((d, l + 2 * halo) + own.shape[2:], dtype=own.dtype, device=own.device)
    err = kernels.lib().pies_halo_refresh(own.data_ptr(), view.data_ptr(), d, l, halo, k,
                                          int(zero_halo), kernels.ptr(left), kernels.ptr(right),
                                          kernels.stream())
    kernels.check(err, "halo_refresh")
    refresh.launches += 1
    return view


refresh.launches = 0


def _check_bands(halo: int, k: int, *bands) -> None:
    for t in bands:
        if t is not None and t.numel() != halo * k:
            raise ValueError(f"an outer band holds B x k = {halo} x {k} values, not {t.numel()}")


def _reduced(view: torch.Tensor, halo: int, left=None, right=None) -> torch.Tensor:
    """``own.at[l-b:].add(from_right).at[:b].add(from_left)`` per slab, a
    missing neighbour's part zero (``_halo_reduce``); ``right`` stands in
    for slab D's left halo and ``left`` for slab −1's right halo (the
    neighbouring ranks' partials)."""
    b = halo
    l = view.shape[1] - 2 * b
    own = view[:, b:b + l].clone()
    if b == 0:
        return own
    z = torch.zeros_like(view[:1, :b])
    from_right = torch.cat([view[1:, :b], z if right is None else right[None]])
    from_left = torch.cat([z if left is None else left[None], view[:-1, b + l:]])
    own[:, l - b:] = own[:, l - b:] + from_right
    own[:, :b] = own[:, :b] + from_left
    return own


def reduce_plain(view: torch.Tensor, halo: int, mode: int = SUM, p=None, x_own=None,
                 prev_own=None, active=None, stat=None, failed=None, left=None, right=None,
                 part=None):
    """Plain twin of T30's reduce, views ``f32[D, V, ...]`` to owned
    ``f32[D, L, ...]``: ``SUM`` the reduced values (with ``p`` f32[D, L, 3]
    also the CG's block partials of p·y over the flat owned index:
    returns ``(y, part)``, the partials written into ``part`` when given),
    ``AVERAGE`` the count-averaged k = 4 accumulators f32[D, L, 3],
    ``APPLY`` that average added to ``x_own`` and ``prev_own`` in place,
    then ``x_own = stat`` where ``active`` > 0 (when given), nothing when
    latch slot 0 of ``failed`` is set; returns None.  ``left`` and
    ``right`` f32[B, ...] are the neighbouring ranks' halo partials, added
    to slab 0's and slab D−1's owned bands in every mode."""
    acc = _reduced(view, halo, left, right)
    if mode == SUM:
        if p is None:
            return acc
        y = acc.reshape(-1, 3)
        q = p.reshape(-1, 3)
        parts = block_partials(q[:, 0] * y[:, 0] + q[:, 1] * y[:, 1] + q[:, 2] * y[:, 2])
        if part is not None:
            part.copy_(parts)
            parts = part
        return acc, parts
    delta = _div(acc[..., :3], torch.clamp_min(acc[..., 3:4], 1.0))
    if mode == AVERAGE:
        return delta
    if bool(failed[0]):
        return None
    prev_own.copy_(prev_own + delta)
    x_new = x_own + delta
    if active is not None:
        x_new = torch.where(active[..., None] > 0, stat, x_new)
    x_own.copy_(x_new)
    return None


def reduce(view: torch.Tensor, halo: int, mode: int = SUM, p=None, x_own=None,
           prev_own=None, active=None, stat=None, failed=None, left=None, right=None,
           part=None):
    """T30's reduce on a CUDA tensor, :func:`reduce_plain` on a CPU one
    (same arguments and results)."""
    if kernels.on_cpu(view):
        return reduce_plain(view, halo, mode, p, x_own, prev_own, active, stat, failed, left,
                            right, part)
    d, vv = view.shape[:2]
    l = vv - 2 * halo
    k = view.shape[2] if view.dim() == 3 else 1
    kernels.require(view.device, view, p, x_own, prev_own, active, stat, failed, left, right,
                    part)
    _check_bands(halo, k, left, right)
    out = None
    if mode == SUM:
        out = torch.empty((d, l) + view.shape[2:], dtype=view.dtype, device=view.device)
    elif mode == AVERAGE:
        out = torch.empty((d, l, 3), dtype=view.dtype, device=view.device)
    parts = -(-d * l // 256)
    if p is not None and part is None:
        part = torch.empty(parts, dtype=torch.float32, device=view.device)
    if part is not None and (p is None or part.numel() != parts):
        raise ValueError(f"the p.Ap partials take p and {parts} slots")
    err = kernels.lib().pies_halo_reduce(
        view.data_ptr(), kernels.ptr(out), d, l, halo, k, mode, kernels.ptr(p),
        kernels.ptr(part), kernels.ptr(x_own), kernels.ptr(prev_own), kernels.ptr(active),
        kernels.ptr(stat), kernels.ptr(failed), kernels.ptr(left), kernels.ptr(right),
        kernels.stream())
    kernels.check(err, "halo_reduce")
    reduce.launches += 1
    if part is not None:
        return out, part
    return out


reduce.launches = 0


def _prefix(counts: torch.Tensor, keep: int):
    kept = torch.clamp_max(counts.reshape(-1).long(), keep)
    pre = torch.cumsum(kept, 0) - kept
    return kept, pre, int(kept.sum())


def merge_plain(src: torch.Tensor, src_mask: torch.Tensor, counts: torch.Tensor, keep: int,
                v: int):
    """Plain twin of T30's merge: the slabs' lists ``src`` i32[D, cap, w]
    (live prefixes of ``counts`` i32[D, 1], kept up to ``keep`` rows) into
    one list i32[D·cap, w] of the flat scene (slab s's node ids + s·V),
    slab after slab, zero past the total; returns ``(idx, mask f32[D·cap],
    count i32[1])``."""
    d, cap, w = src.shape
    kept, pre, total = _prefix(counts, keep)
    idx = torch.zeros((d * cap, w), dtype=torch.int32, device=src.device)
    mask = torch.zeros(d * cap, dtype=torch.float32, device=src.device)
    for s in range(d):
        n = int(kept[s])
        idx[int(pre[s]):int(pre[s]) + n] = src[s, :n] + s * v
        mask[int(pre[s]):int(pre[s]) + n] = src_mask[s, :n]
    return idx, mask, torch.full((1,), total, dtype=torch.int32, device=src.device)


def merge(src: torch.Tensor, src_mask: torch.Tensor, counts: torch.Tensor, keep: int, v: int):
    """T30's merge on CUDA tensors, :func:`merge_plain` on CPU tensors (the
    count stays on the device)."""
    if kernels.on_cpu(src):
        return merge_plain(src, src_mask, counts, keep, v)
    d, cap, w = src.shape
    kernels.require(src.device, src, src_mask, counts)
    idx = torch.empty((d * cap, w), dtype=torch.int32, device=src.device)
    mask = torch.empty(d * cap, dtype=torch.float32, device=src.device)
    count = torch.empty(1, dtype=torch.int32, device=src.device)
    err = kernels.lib().pies_halo_merge(src.data_ptr(), src_mask.data_ptr(), counts.data_ptr(),
                                        d, cap, w, keep, v, idx.data_ptr(), mask.data_ptr(),
                                        count.data_ptr(), kernels.stream())
    kernels.check(err, "halo_merge")
    merge.launches += 1
    return idx, mask, count


merge.launches = 0


PAIR_FIELDS = ("pi", "pj", "count", "row_off", "inc_start", "inc_pair")


def merge_pairs_plain(caches, keep: int, v: int) -> dict[str, torch.Tensor]:
    """Plain twin of T30's pair merge: the slabs' T20 caches (a stacked
    ``NodePairCache`` with a leading slab axis, each a prefix of its
    count, kept up to ``keep`` pairs) into the flat scene's pair lists
    (``PAIR_FIELDS``): the kept pairs slab after slab (node ids + s·V),
    ``row_off`` clipped to them, the j-lists at s·W with their pair
    indices shifted by the slab's offset and ``SENTINEL`` for a dropped
    pair or an empty slot."""
    d, width = caches.pi.shape
    dev = caches.pi.device
    kept, pre, total = _prefix(caches.count, keep)
    i32 = dict(dtype=torch.int32, device=dev)
    pi, pj = torch.zeros(d * width, **i32), torch.zeros(d * width, **i32)
    row_off = torch.empty(d * v + 1, **i32)
    inc_start = torch.empty(d * v + 1, **i32)
    inc_pair = torch.full((d, width), SENTINEL, **i32)
    slot = torch.arange(width, device=dev)
    for s in range(d):
        n, at = int(kept[s]), int(pre[s])
        pi[at:at + n] = caches.pi[s, :n] + s * v
        pj[at:at + n] = caches.pj[s, :n] + s * v
        q = caches.inc_pair[s].long()
        live = (slot < int(caches.count[s, 0])) & (q < n)
        inc_pair[s] = torch.where(live, q + at, SENTINEL).to(torch.int32)
        row_off[s * v:(s + 1) * v] = torch.clamp_max(caches.row_off[s, :v], n) + at
        inc_start[s * v:(s + 1) * v] = caches.inc_start[s, :v] + s * width
    row_off[-1] = total
    inc_start[-1] = d * width
    return dict(pi=pi, pj=pj, count=torch.full((1,), total, **i32), row_off=row_off,
                inc_start=inc_start, inc_pair=inc_pair.reshape(-1))


def merge_pairs(caches, keep: int, v: int) -> dict[str, torch.Tensor]:
    """T30's pair merge on CUDA tensors, :func:`merge_pairs_plain` on CPU
    tensors."""
    if kernels.on_cpu(caches.pi):
        return merge_pairs_plain(caches, keep, v)
    d, width = caches.pi.shape
    src = [getattr(caches, f) for f in PAIR_FIELDS]
    kernels.require(caches.pi.device, *src)
    i32 = dict(dtype=torch.int32, device=caches.pi.device)
    out = dict(pi=torch.empty(d * width, **i32), pj=torch.empty(d * width, **i32),
               count=torch.empty(1, **i32), row_off=torch.empty(d * v + 1, **i32),
               inc_start=torch.empty(d * v + 1, **i32), inc_pair=torch.empty(d * width, **i32))
    err = kernels.lib().pies_halo_merge_pairs(
        *(t.data_ptr() for t in src), *(out[f].data_ptr() for f in PAIR_FIELDS), d, v, width,
        keep, kernels.stream())
    kernels.check(err, "halo_merge_pairs")
    merge_pairs.launches += 1
    return out


merge_pairs.launches = 0
