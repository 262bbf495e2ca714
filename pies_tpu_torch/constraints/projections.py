"""Tet local step and force (port of the fused path of
``pies_tpu/constraints/projections.py:194-207,280-356``).

:func:`tet_force12` is the wrapper of kernel T1 (``kernels/csrc/
tet_force.cu``), the element-major form of the tet-column path;
:func:`tet_force12_gathered` is stage 1 of kernel T9 (``kernels/csrc/
tet_force_nodes.cu``), the shared-node form that gathers its corners through
the tet ids.  :func:`tet_force12_plain` and :func:`tet_force12_gathered_plain`
are their plain PyTorch twins, used for CPU tensors and as the oracles on
the card.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..ops import math3d
from ..topology import TetBatch


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
    accepted for signature parity; a skipped tick ignores the result."""
    c = strain.qinv.shape[1]
    return torch.stack(tet_force12_fused_cols(corner_cols(x, c), strain, volume))


def tet_force12(x: torch.Tensor, strain: TetBatch, volume: TetBatch,
                failed: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel T1 on a CUDA tensor, its plain twin on a CPU tensor.

    ``failed`` (the state's ``i32[2]`` latch) makes the kernel return at once
    when slot 0 is set."""
    if kernels.on_cpu(x):
        return tet_force12_plain(x, strain, volume, failed)
    c = strain.qinv.shape[1]
    if x.shape[0] < 4 * c:
        raise ValueError(f"{c} tets need {4 * c} nodes, got {x.shape[0]}")
    b = (strain.qinv, strain.g, strain.lo, strain.hi, strain.w,
         volume.lo, volume.hi, volume.w)
    kernels.require(x.device, x, failed, *b)
    out = torch.empty((12, c), dtype=torch.float32, device=x.device)
    err = kernels.lib().pies_tet_force12(
        x.data_ptr(), *(t.data_ptr() for t in b), out.data_ptr(), c,
        kernels.ptr(failed), kernels.stream(),
    )
    kernels.check(err, "tet_force12")
    tet_force12.launches += 1
    return out


tet_force12.launches = 0


def tet_force12_gathered_plain(x: torch.Tensor, strain: TetBatch, volume: TetBatch,
                               failed: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of T9's stage 1 (``tet_force12_fused`` with the gather,
    ``projections.py:280-308``): the combined force of every tet of the
    batch, corners gathered from ``x`` f32[N, 3] through ``strain.idx``, as
    the JAX scatter's update rows ``blocks`` f32[4C, 3] (row ``a·C + t`` is
    corner a of tet t).  ``failed`` is accepted for signature parity."""
    idx = strain.idx.long()
    p = [[x[idx[:, a], d] for d in range(3)] for a in range(4)]
    f12 = tet_force12_fused_cols(p, strain, volume)
    return torch.cat([torch.stack(f12[3 * a:3 * a + 3], dim=1) for a in range(4)])


def tet_force12_gathered(x: torch.Tensor, strain: TetBatch, volume: TetBatch,
                         failed: torch.Tensor | None = None) -> torch.Tensor:
    """T9's stage 1 on a CUDA tensor, its plain twin on a CPU tensor.  On the
    card ``failed`` is required: the kernel returns at once when its slot 0
    is set."""
    if kernels.on_cpu(x):
        return tet_force12_gathered_plain(x, strain, volume, failed)
    if failed is None:
        raise ValueError("the gathered tet-force kernel needs the failure latch")
    c = strain.qinv.shape[1]
    if tuple(strain.idx.shape) != (c, 4):
        raise ValueError(f"tet ids must be [{c}, 4], got {tuple(strain.idx.shape)}")
    b = (strain.qinv, strain.g, strain.lo, strain.hi, strain.w,
         volume.lo, volume.hi, volume.w)
    kernels.require(x.device, x, strain.idx, failed, *b)
    blocks = torch.empty((4 * c, 3), dtype=torch.float32, device=x.device)
    err = kernels.lib().pies_tet_force12_gather(
        x.data_ptr(), strain.idx.data_ptr(), *(t.data_ptr() for t in b),
        blocks.data_ptr(), c, failed.data_ptr(), kernels.stream(),
    )
    kernels.check(err, "tet_force12_gather")
    tet_force12_gathered.launches += 1
    return blocks


tet_force12_gathered.launches = 0
