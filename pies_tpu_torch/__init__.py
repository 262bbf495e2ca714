"""pies_tpu_torch — the PyTorch + CUDA port of pies_tpu.

A second package beside the JAX reference ``pies_tpu``: the same ``Solver``
surface and the same physics, with the hot path in hand-written CUDA kernels
for Hopper (``kernels/csrc``) and a plain PyTorch twin beside each kernel.
It imports ``torch`` and never ``jax``.  The ported scope is the PD tick
with floor contact and point-triangle self-contact (in every coupling
mode) on disjoint tet soups (the tet-column path) and every other scene the
builders make (the generic path, which also runs edge-edge and node-node
contacts), and the PBD solver; the mesher (``Solver.add_tri_mesh_volume``,
``scene.tetmesh``), the diagnostics (``diagnostics``), scene ensembles
(``parallel.ensemble``) and the spatial domain decomposition of one scene
into slabs (``parallel.domain``), on one card or spread over
``torch.distributed`` ranks (``parallel.ranks``).
"""

import torch

from .options import (
    CollisionBudget,
    PhysicsParams,
    SolverName,
    SolverOptions,
    StepConfig,
    make_params,
    split_options,
)
from .solver.host import Solver
from .state import SolverState, load_state, make_state, save_state
from .topology import Topology

# Full float32 for matrix products (the GPU form of pies_tpu/ops/precision.py).
# The slice has no matmul; this guards the ones later ports bring.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "CollisionBudget",
    "PhysicsParams",
    "Solver",
    "SolverName",
    "SolverOptions",
    "SolverState",
    "StepConfig",
    "Topology",
    "load_state",
    "make_params",
    "make_state",
    "save_state",
    "split_options",
]
