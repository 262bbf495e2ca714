"""PD system diagonal (port of the dense-floor branch of
``pies_tpu/solver/assembly.py:338-354,577-599``).

The generic PD path (matrix-free apply, PCG, the other constraint families)
is not ported yet: the tet-column slice solves its 4x4 blocks directly.
"""

from __future__ import annotations

import torch

from ..collision.batches import W_STATIC, CollisionSet
from ..topology import Topology


def static_collision_diag(colls: CollisionSet, floor_count: torch.Tensor) -> torch.Tensor:
    """Per-node diagonal of the floor-contact constraints: count · w · active
    (diagonal-only, ``CollisionConstraint.cpp:442-445``)."""
    return W_STATIC * floor_count * colls.floor_active


def system_diag(mass_over_h2: torch.Tensor, topo: Topology,
                colls: CollisionSet) -> torch.Tensor:
    """The assembled diagonal of the PD system with this substep's floor
    contacts (``Solver.cpp:179-210,242-259``)."""
    diag = mass_over_h2 + topo.stiffness_diag
    return diag + static_collision_diag(colls, topo.floor_count)
