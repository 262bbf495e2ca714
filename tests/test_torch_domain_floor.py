"""Floor contact without stabilization passes, in the port's domain and
single scene, against the JAX package's: four tet boxes moving into the
floor in 4 slabs, ``collision_stabilization_iterations=0``, where the
reference snaps no floor-active node (its snap sits inside the passes,
``pies_tpu/solver/pd.py:353-355`` and ``pies_tpu/parallel/domain.py:905-909``).

* The domain: both packages from one partition, one tick within 3e-6 (or
  3x the JAX package's own domain-against-single spread), 10 ticks
  likewise, the latch on the same tick (``domain_cases.py``).
* The single scene: the port's tick against the JAX package's jitted tick
  from one state, the first within 3e-6 and each of 10 within 1e-4 (the
  tet boxes' trajectory bound of ``tests/test_parallel.py``); a snap
  of the floor-active nodes parts them by ~1.5e-3 from the second tick.
* Without JAX: the port's domain against its own single scene over 40
  ticks (one tick 1e-5, then 1e-4).
"""

import jax
import numpy as np
import pytest

import pies_tpu
from pies_tpu.options import CollisionBudget as JBudget, SolverOptions as JOptions
from pies_tpu.solver import step as jstep

from domain_cases import OPT0, STEP_TOL, build, check_against_jax, check_single, run_case
from torch_threads import two_threads  # noqa: F401

NAME = "floor_boxes"
TRAJ_TOL = 1e-4


@pytest.fixture(scope="module")
def case():
    return run_case(NAME)


def test_domain_tick_matches_jax(case):
    check_against_jax(case)


def test_single_scene_matches_jax_without_passes():
    import pies_tpu_torch as pt
    from pies_tpu_torch.options import CollisionBudget
    from pies_tpu_torch.solver import pd, step

    js = build(NAME, pies_tpu.Solver, JOptions, JBudget)
    ps = build(NAME, pt.Solver, pt.SolverOptions, CollisionBudget, device="cpu")
    n = ps._builder.num_nodes
    jtick = jax.jit(jstep.tick, static_argnames=("config",), compiler_options=OPT0)
    jstate, params = js._state, js.current_params()
    active = 0
    for t in range(10):
        jstate, _ = jtick(jstate, js._topology, params, config=js._config)
        c = pd.new_counters("cpu")
        step.tick(ps.state, ps.topology, ps.current_params(), ps.config, counters=c)
        active += int(c["floor_active"])
        apart = np.abs(np.asarray(jstate.positions)[:n] - ps.state.positions[:n].numpy()).max()
        assert apart <= (STEP_TOL if t == 0 else TRAJ_TOL), (t, apart)
    assert active > 0, "no floor contact"
    assert not bool(np.asarray(jstate.sim_failed)) and not ps.state.failed()


def test_domain_matches_the_single_scene():
    check_single(NAME)
