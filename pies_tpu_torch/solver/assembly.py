"""PD system diagonal (port of the dense-floor and point-triangle branches
of ``pies_tpu/solver/assembly.py:338-368,577-599``).

The generic PD path (matrix-free apply, PCG, the other constraint families)
is not ported yet: the tet-column slice solves its 4x4 blocks directly.
"""

from __future__ import annotations

import torch

from ..collision.batches import (
    ATA_DIFF4,
    W_POINT_TRI,
    W_STATIC,
    CollisionSet,
    Incidence,
    csr_sum,
    incidence_plain,
)
from ..topology import Topology


def static_collision_diag(colls: CollisionSet, floor_count: torch.Tensor) -> torch.Tensor:
    """Per-node diagonal of the floor-contact constraints: count · w · active
    (diagonal-only, ``CollisionConstraint.cpp:442-445``)."""
    return W_STATIC * floor_count * colls.floor_active


def point_tri_collision_diag(pt_idx: torch.Tensor, pt_mask: torch.Tensor, num_nodes: int,
                             inc: Incidence | None = None) -> torch.Tensor:
    """Dense per-node ``w·(AᵀA)ᵢᵢ`` of the point-triangle contacts (the
    recentered coupling's diagonal), summed per node in the JAX package's
    scatter order.  ``inc`` defaults to every entry of the buffer."""
    if inc is None:
        count = torch.full((1,), pt_idx.shape[0], dtype=torch.int32, device=pt_idx.device)
        inc = incidence_plain(pt_idx, count, num_nodes)
    wk = W_POINT_TRI * pt_mask
    vals = torch.cat([wk * float(ATA_DIFF4[a, a]) for a in range(4)])[:, None]
    return csr_sum(inc, vals)[:, 0]


def system_diag(mass_over_h2: torch.Tensor, topo: Topology,
                colls: CollisionSet) -> torch.Tensor:
    """The assembled diagonal of the PD system with this substep's floor
    contacts (``Solver.cpp:179-210,242-259``); the point-triangle term is
    folded in between the two sums by ``tetcols.pt_coupling_setup``."""
    diag = mass_over_h2 + topo.stiffness_diag
    return diag + static_collision_diag(colls, topo.floor_count)
