"""Solver configuration (port of ``pies_tpu/options.py``).

``SolverOptions`` mirrors the reference's public struct field for field, as in
the JAX package.  ``CollisionBudget`` is the JAX package's, field for field.
``StepConfig`` keeps only the static fields the ported paths read;
``PhysicsParams`` holds plain Python floats (there is no tracing, so nothing
has to become a device scalar).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class SolverName(enum.Enum):
    """Mirrors ``Pies::SolverName`` (``Solver.h:21``)."""

    PBD = "pbd"
    PD = "pd"


@dataclass(frozen=True)
class SolverOptions:
    """Field-for-field mirror of ``Pies::SolverOptions`` (``Solver.h:23-38``),
    with the reference's defaults.  ``thread_count`` is accepted for parity
    and unused."""

    fixed_timestep_size: float = 0.012
    time_substeps: int = 1
    iterations: int = 4
    collision_stabilization_iterations: int = 4
    collision_threshold_distance: float = 0.1
    collision_thickness: float = 0.05
    gravity: float = 10.0
    damping: float = 0.006
    friction: float = 0.01
    static_friction_threshold: float = 0.0
    floor_height: float = 0.0
    grid_spacing: float = 2.0
    thread_count: int = 8
    solver: SolverName = SolverName.PD


@dataclass(frozen=True)
class CollisionBudget:
    """Static capacities of the collision pipeline
    (``pies_tpu/options.py:65-111``), with the same fields and defaults.
    Exceeding a capacity that would lose a true contact latches
    ``sim_failed``, as the reference's bucket caps do
    (``Solver.cpp:741-755``)."""

    max_cells_per_tri: int = 64
    max_entries_per_cell: int = 16
    max_candidates_per_tri: int = 64
    max_point_tri_contacts: int = 256
    max_edge_contacts: int = 256
    max_narrow_candidates: int = 32
    # Triangles per collision body (4 faces per tet in a soup); 1 = general.
    body_stride: int = 1
    max_candidates_per_body: int = 24
    max_narrow_bodies: int = 8
    max_candidates_per_node: int = 32
    max_cells_per_node: int = 27
    max_node_node_contacts: int = 256


@dataclass(frozen=True)
class StepConfig:
    """The static fields of ``pies_tpu.options.StepConfig`` that the ported
    PD and PBD paths read, with the same meanings and defaults."""

    solver: SolverName = SolverName.PD
    time_substeps: int = 1
    iterations: int = 4
    collision_stabilization_iterations: int = 4
    # Jacobi-PCG of the generic path: the trip cap, and the relative
    # early-exit tolerance (0 = always ``cg_iterations`` trips).
    cg_iterations: int = 16
    cg_rtol: float = 0.0
    # Trips of the shape-matching rotation extraction (ops.math3d.
    # extract_rotation), warm-started from the state's quaternions.
    rotation_iterations: int = 20
    enable_collisions: bool = True
    # Edge-edge contacts between triangles' edges (``step.py:75-86``) and
    # the PD node-node contacts (``step.py:87-91``); PBD's node-node
    # response follows ``enable_collisions``.
    enable_edge_collisions: bool = False
    enable_node_collisions: bool = False
    dense_floor: bool = True
    reference_quirks: bool = True
    broadphase_mode: str = "celllist"
    tet_fused: bool = False
    allpairs_broadphase_max: int = 1024
    strain_contiguous: bool = False
    volume_contiguous: bool = False
    # Packed-body layout, set by the host: body b owns nodes
    # ``body_node_offset + b·body_nodes + (0 .. body_nodes−1)`` and its
    # ``budget.body_stride`` triangles use the local corners ``body_faces``.
    body_nodes: int = 0
    body_node_offset: int = 0
    body_faces: tuple = ()
    # Super-body layout, set by the host for a triangle scene without an
    # all-covering uniform body stride (``super_k == 0`` disables): rows
    # ``0 .. super_packed_k−1`` are a uniform packed prefix
    # (``super_packed_m`` contiguous nodes each from ``super_packed_off``),
    # every other live row is one "loose" triangle with explicit corner ids
    # (``Topology.super_corners``, padded to the packed corner width).
    super_k: int = 0  # body rows, padding included
    super_packed_k: int = 0
    super_packed_m: int = 0
    super_packed_off: int = 0
    super_live_k: int = 0  # live rows (packed + loose)
    # Local corner patterns of every face slot: the first ``super_packed_e``
    # are the packed bodies' faces, slot ``super_loose_face`` (the (0, 1, 2)
    # pattern; −1 without loose rows) is a loose row's single face.
    super_faces: tuple = ()
    super_packed_e: int = 0
    super_loose_face: int = -1
    # Temporal broadphase cache (state.BroadphaseCache), when the host
    # allocated one.
    bp_cache: bool = True
    contact_coupling: str = "full"
    # The PBD distance form, set by the host: the cumulative end offsets of
    # the colour classes of the (host-reordered) distance batch, projected
    # class after class in place; and the chain scan down the rope links of
    # ``Topology.chains``, which takes precedence.  Neither: count-averaged
    # Jacobi.
    distance_colors: tuple = ()
    distance_chain: bool = False
    tet_cols: bool = True
    budget: CollisionBudget = CollisionBudget()
    # Accepted for parity with the JAX package, which never reads it either.
    dtype: str = "float32"


def _f32(v) -> float:
    """The float32 value of ``v`` as a Python float: the kernels and the plain
    twins then see the same scalar the JAX package traces as ``f32``."""
    return float(np.float32(v))


@dataclass(frozen=True)
class PhysicsParams:
    """The scalar parameters of a step that the slice reads
    (``pies_tpu.options.PhysicsParams``), each rounded to float32 like the
    JAX package's traced scalars."""

    dt: float
    gravity: float
    damping: float
    friction: float
    static_friction_threshold: float
    floor_height: float
    collision_threshold_distance: float
    collision_thickness: float
    # Cell size of the reference-mode triangle grid without its quirks
    # (``Solver.cpp:659-670``).
    grid_spacing: float
    # Cell size of the body broadphase grid (world units) and the temporal
    # cache's displacement bound (world units per axis; 0 = rebuild every
    # substep), set per scene by the host.
    broadphase_cell: float = 1.0
    broadphase_slack: float = 0.0
    # The PBD toggle gating the position pins (``Solver.h:52``,
    # ``Solver.cpp:59-63``): 1.0 releases them.
    release_hinge: float = 0.0


def split_options(options: SolverOptions, **config_overrides) -> tuple[StepConfig, PhysicsParams]:
    """Map the reference-shaped options onto (static, dynamic) halves
    (``pies_tpu/options.py:318-330``)."""
    config = StepConfig(
        solver=options.solver,
        time_substeps=int(options.time_substeps),
        iterations=int(options.iterations),
        collision_stabilization_iterations=int(options.collision_stabilization_iterations),
        **config_overrides,
    )
    return config, make_params(options)


def make_params(options: SolverOptions, release_hinge: bool = False,
                broadphase_cell: float = 1.0, broadphase_slack: float = 0.0) -> PhysicsParams:
    """The step's scalars, with the JAX package's argument order
    (``pies_tpu/options.py:333-338``)."""
    return PhysicsParams(
        dt=_f32(options.fixed_timestep_size / max(1, options.time_substeps)),
        gravity=_f32(options.gravity),
        damping=_f32(options.damping),
        friction=_f32(options.friction),
        static_friction_threshold=_f32(options.static_friction_threshold),
        floor_height=_f32(options.floor_height),
        collision_threshold_distance=_f32(options.collision_threshold_distance),
        collision_thickness=_f32(options.collision_thickness),
        grid_spacing=_f32(options.grid_spacing),
        broadphase_cell=_f32(broadphase_cell),
        broadphase_slack=_f32(broadphase_slack),
        release_hinge=1.0 if release_hinge else 0.0,
    )
