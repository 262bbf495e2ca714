"""Per-substep floor contacts (port of the dense-floor part of
``pies_tpu/collision/batches.py``).

Weights mirror the reference headers; only the floor constraint is used by
the ported slice, the others are carried for the self-contact port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

W_POINT_TRI = 1.0e4  # PointTriangleCollisionConstraint (CollisionConstraint.h:33)
W_STATIC = 1.0e4  # StaticCollisionConstraint, the floor (CollisionConstraint.h:78)

# AᵀA of the point-triangle / edge collision differential matrix
# A = [[0,0,0,0],[-1,1,0,0],[-1,0,1,0],[-1,0,0,1]]
# (CollisionConstraint.cpp:74-84,202-211).
ATA_DIFF4 = np.array(
    [
        [3.0, -1.0, -1.0, -1.0],
        [-1.0, 1.0, 0.0, 0.0],
        [-1.0, 0.0, 1.0, 0.0],
        [-1.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)


@dataclass
class CollisionSet:
    """The constraints detected for one substep.  With self-contact off and
    dense floor contacts, that is one per-node activity mask."""

    floor_active: torch.Tensor  # f32[N]


def floor_threshold(params) -> float:
    """``floor_height + thickness`` rounded as the float32 sum the JAX
    package computes on the device."""
    return float(np.float32(params.floor_height) + np.float32(params.collision_thickness))


def detect_floor_active(positions: torch.Tensor, floor_count: torch.Tensor,
                        threshold: float) -> torch.Tensor:
    """Per node, 1.0 when it has live incident triangles and
    ``y < floorHeight + thickness`` (``Solver.cpp:829-834``, hoisted to the
    node).  Returns ``f32[N]``."""
    hit = (positions[:, 1] < threshold) & (floor_count > 0)
    return hit.to(positions.dtype)


def floor_plane(params, reference_quirks: bool) -> float:
    """The plane the floor projection clamps to.  Quirk mode uses y = 0
    whatever the floor height, as the reference does
    (``CollisionConstraint.cpp:447-455``; FIDELITY.md), while detection uses
    the floor height."""
    return 0.0 if reference_quirks else params.floor_height
