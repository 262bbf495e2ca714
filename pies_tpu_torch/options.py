"""Solver configuration (port of ``pies_tpu/options.py``).

``SolverOptions`` mirrors the reference's public struct field for field, as in
the JAX package.  ``StepConfig`` keeps only the static fields the ported slice
reads; ``PhysicsParams`` holds plain Python floats (there is no tracing, so
nothing has to become a device scalar).
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
class StepConfig:
    """The static fields of ``pies_tpu.options.StepConfig`` that the PD
    tet-column slice reads, with the same meanings and defaults."""

    solver: SolverName = SolverName.PD
    time_substeps: int = 1
    iterations: int = 4
    enable_collisions: bool = True
    dense_floor: bool = True
    reference_quirks: bool = True
    tet_fused: bool = False
    strain_contiguous: bool = False
    volume_contiguous: bool = False
    contact_coupling: str = "full"
    tet_cols: bool = True


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
    collision_thickness: float


def make_params(options: SolverOptions) -> PhysicsParams:
    return PhysicsParams(
        dt=_f32(options.fixed_timestep_size / max(1, options.time_substeps)),
        gravity=_f32(options.gravity),
        damping=_f32(options.damping),
        friction=_f32(options.friction),
        static_friction_threshold=_f32(options.static_friction_threshold),
        floor_height=_f32(options.floor_height),
        collision_thickness=_f32(options.collision_thickness),
    )
