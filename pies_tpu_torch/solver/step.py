"""Tick and multi-tick stepping (port of ``pies_tpu/solver/step.py:95-185``).

A tick is ``time_substeps`` PD or PBD substeps, as ``config.solver`` says.  The JAX package wraps the tick in
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
from .pbd import pbd_substep
from .pd import pd_substep


def default_detect_node_pairs(state, x, vel, params: PhysicsParams, config: StepConfig,
                              cache, plain: bool = False):
    """The PBD node-node response (``pies_tpu/solver/step.py:95-102``,
    ``Solver.cpp:81-130``): ``(x, vel, touching, rebuilt)`` from
    ``broadphase.pbd_node_node_response``, or the inputs as they are with
    collisions off."""
    if not config.enable_collisions:
        return x, vel, None, None
    from ..collision.broadphase import pbd_node_node_response

    return pbd_node_node_response(state, x, vel, params, config, cache, plain)


def tick(state: SolverState, topo: Topology, params: PhysicsParams,
         config: StepConfig, plain: bool = False, counters=None) -> torch.Tensor:
    """One solver tick, in place on ``state``; returns the last substep's
    residual as a device scalar (0 for a skipped tick, and always for PBD).
    ``counters``: see ``pd.new_counters`` and ``pbd.new_counters``."""
    res = None
    for i in range(config.time_substeps):
        if config.solver == SolverName.PD:
            res = pd_substep(state, topo, params, config, fold=(i == 0), plain=plain,
                             counters=counters)
        else:
            res = pbd_substep(state, topo, params, config, default_detect_node_pairs,
                              fold=(i == 0), plain=plain, counters=counters)
    return res


def tick_n(state: SolverState, topo: Topology, params: PhysicsParams,
           config: StepConfig, n: int, plain: bool = False, counters=None) -> torch.Tensor:
    """``n`` ticks of launches with no host sync; returns the last residual."""
    res = None
    for _ in range(n):
        res = tick(state, topo, params, config, plain=plain, counters=counters)
    return res
