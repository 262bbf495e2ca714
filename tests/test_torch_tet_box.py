"""The port's generic PD path on ``create_tet_box`` against the JAX package,
driven through both packages' ``Solver`` with self-contact off (the tet box
with self-contact: ``tests/test_torch_tri_detect.py``).  The JAX package runs
with ``dense_operator_max=0`` so that both take Jacobi-PCG.

Tolerance and why: 20 ticks of the tet box, 5e-5 absolute.  Measured against
a float64 run of the port: the JAX package parts by 4.8e-6 (4.1e-6 with the
early exit), the port by 1.3e-5 (1.8e-5); the port parts from the JAX
package by 1.0e-5 (1.6e-5).
"""

import numpy as np
import pytest

import pies_tpu
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
import pies_tpu_torch as pt
from pies_tpu_torch.solver import pd as tpd

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

BOX_TOL = 5e-5


@pytest.mark.parametrize("rtol", [0.0, 1e-6], ids=["fixed", "early_exit"])
def test_tet_box_matches_reference(rtol):
    """``create_tet_box`` with a 32-trip cap (tests/test_solver.py:411): 20
    ticks in both packages, with the early exit on and off."""
    kw = dict(enable_collisions=False, cg_iterations=32, cg_rtol=rtol)
    j = pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0, **kw)
    t = pt.Solver(pt.SolverOptions(), device="cpu", **kw)
    for s in (j, t):
        s.create_tet_box((0, 2.0, 0), 1.0, (0, 0, 0), w=1500.0, mass=1.0)
    t.counters = tpd.new_counters("cpu")
    for _ in range(20):
        j.tick()
        t.tick()
    trips = int(t.counters["cg_trips"])
    assert (trips < 20 * 4 * 32) if rtol else (trips == 20 * 4 * 32)
    a = np.asarray(j._state.positions)[:27]
    b = t.state.positions[:27].numpy()
    assert np.abs(a - b).max() <= BOX_TOL
    assert not t.sim_failed and not j.sim_failed
