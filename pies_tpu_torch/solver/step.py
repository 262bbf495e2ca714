"""Tick and multi-tick stepping (port of ``pies_tpu/solver/step.py:105-185``).

A tick is ``time_substeps`` PD substeps.  The JAX package wraps the tick in
``lax.cond(sim_failed, skip, run)``; here every kernel reads the device-side
latch and returns at once, so a failed state is left as it is without the
host ever waiting for the device.  ``lax.scan`` becomes a Python loop of
launches.
"""

from __future__ import annotations

import torch

from ..options import PhysicsParams, SolverName, StepConfig
from ..state import SolverState
from ..topology import Topology
from .pd import pd_substep


def tick(state: SolverState, topo: Topology, params: PhysicsParams,
         config: StepConfig, plain: bool = False, counters=None) -> torch.Tensor:
    """One solver tick, in place on ``state``; returns the last substep's
    residual as a device scalar (0 for a skipped tick).  ``counters``: see
    ``pd.new_counters``."""
    if config.solver != SolverName.PD:
        raise NotImplementedError("the PBD solver is ROADMAP queue 1 item 7")
    res = None
    for i in range(config.time_substeps):
        res = pd_substep(state, topo, params, config, fold=(i == 0), plain=plain,
                         counters=counters)
    return res


def tick_n(state: SolverState, topo: Topology, params: PhysicsParams,
           config: StepConfig, n: int, plain: bool = False, counters=None) -> torch.Tensor:
    """``n`` ticks of launches with no host sync; returns the last residual."""
    res = None
    for _ in range(n):
        res = tick(state, topo, params, config, plain=plain, counters=counters)
    return res
