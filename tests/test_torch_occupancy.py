"""The broadphase's candidate occupancy and health (the plain twin of
kernel T29: ``collision.broadphase.candidate_occupancy``,
``diagnostics.broadphase_health``) against the JAX package, on the CPU.

As in ``tests/test_torch_diagnostics.py`` the JAX functions run op by op
(``jax.disable_jit``): under ``jax.jit`` XLA turns the swept boxes'
``x / cell`` into a product with the reciprocal, which moves a bound by an
ulp, and the budget-cliff soup is spaced so that neighbouring tets' swept
boxes lie exactly the CCD margin apart (spacing 0.9, tets of 0.8, margin
0.1): there the jitted ``candidate_occupancy`` counts other neighbours
than the function itself run op by op, which the port follows.

* ``candidate_occupancy`` in each of its three branches, in the JAX
  order: a body stride (a tet soup on its packed bodies), all-pairs (two
  tet boxes thrown together, 96 rows) and the cell list (the same boxes
  with ``allpairs_broadphase_max=0``), each on a contact-active state of
  the port: ``(count_max, count_mean, budget)`` equal, and
  ``broadphase_health`` equal, key for key, with the detection of both
  packages rebuilding from the same state.
* ``tests/test_diagnostics.py:125-160``'s budget cliff: six ticks of the
  port, the cliff visible over them as the JAX test asserts (the contact
  buffer full, candidate demand above its budget, no latch), and the last
  state's health equal to the JAX package's.

The ``gpu`` tests hold T29 to its twin in each branch on the card.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import pies_tpu
from pies_tpu import diagnostics as jdiag
from pies_tpu.collision.broadphase import candidate_occupancy as jocc
from pies_tpu.options import CollisionBudget as JBudget
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
import pies_tpu_torch as pt
from pies_tpu_torch import diagnostics as tdiag
from pies_tpu_torch.collision import broadphase as tb
from pies_tpu_torch.scene.contact_piles import add_tet_boxes

from test_torch_diagnostics import _both, _with_port_state
from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

CLIFF = dict(max_cells_per_tri=32, max_entries_per_cell=32, max_candidates_per_tri=96,
             max_narrow_candidates=16, max_point_tri_contacts=8)
# The scenes of candidate_occupancy's three branches, the arguments of both
# packages' Solver, and the ticks the port runs first (to live contacts).
BRANCH_SCENES = {
    "bodies": (lambda s: s.create_tet_soup(32, spacing=1.0, scale=0.8, w=2000.0, height=0.3),
               {}, 34),
    "allpairs": (add_tet_boxes, {}, 8),
    "celllist": (add_tet_boxes, dict(allpairs_broadphase_max=0), 8),
}


def _host(d):
    return {k: float(v) if isinstance(v, jax.Array) else v for k, v in d.items()}


@pytest.mark.parametrize("branch", list(BRANCH_SCENES))
def test_candidate_occupancy_and_health_match_reference(branch):
    build, kw, ticks = BRANCH_SCENES[branch]
    j, t = _both(build, ticks, enable_collisions=True, **kw)
    assert tb.occupancy_layout(t.config, t.topology.triangles.shape[0]).mode == branch
    st, topo = t.state, t.topology
    with jax.disable_jit():
        ref = jocc(jnp.asarray(st.positions.numpy()), jnp.asarray(st.prev_positions.numpy()),
                   j.topology.triangles, j.topology.tri_mask, j.current_params(), j._config)
    ours = tb.candidate_occupancy(st.positions, st.prev_positions, topo.triangles,
                                  topo.tri_mask, t.current_params(), t.config)
    assert ours == (int(ref[0]), float(ref[1]), int(ref[2])) and ours[0] > 0
    # Health from the same state, each detection rebuilding (no cache).
    _with_port_state(j, t)
    t.state.bp = None
    with jax.disable_jit():
        ref_h = _host(jdiag.broadphase_health(j))
    ours_h = tdiag.broadphase_health(t)
    assert ours_h == ref_h and ours_h["pt_contacts_live"] > 0


def test_budget_cliff_health_matches_reference():
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=True,
                        budget=JBudget(**CLIFF))
    t = pt.Solver(pt.SolverOptions(), enable_collisions=True, device="cpu",
                  budget=pt.CollisionBudget(**CLIFF))
    for s in (j, t):
        s.create_tet_soup(12, spacing=0.9, scale=0.8, w=2000.0, height=0.3)
    j._prepare()
    max_contact_occ = max_cand_occ = 0.0
    for tick in range(1, 7):
        t.tick()
        h = tdiag.broadphase_health(t)
        max_contact_occ = max(max_contact_occ, h["pt_contact_occupancy"])
        max_cand_occ = max(max_cand_occ, h["candidate_occupancy"])
    assert not t.sim_failed and h["pt_contact_cap"] == 8
    assert max_contact_occ == 1.0 and max_cand_occ > 1.0
    # The last tick's state through both packages, each detection rebuilding.
    _with_port_state(j, t)
    t.state.bp = None
    with jax.disable_jit():
        assert tdiag.broadphase_health(t) == _host(jdiag.broadphase_health(j))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("branch", list(BRANCH_SCENES))
def test_occupancy_kernel_equals_its_twin(cuda, branch):
    build, kw, ticks = BRANCH_SCENES[branch]
    t = pt.Solver(pt.SolverOptions(), enable_collisions=True, device=cuda, **kw)
    build(t)
    t.run_ticks(ticks)
    st, topo = t.state, t.topology
    lay = tb.occupancy_layout(t.config, topo.triangles.shape[0])
    args = (st.positions, st.prev_positions, topo.triangles, topo.tri_mask, lay,
            tb.scalars(t.current_params()))
    launches = tb.occupancy.launches
    k, p = tb.occupancy(*args), tb.occupancy_plain(*args)
    assert tb.occupancy.launches == launches + 1
    assert torch.equal(k, p) and int(k[0]) > 0, (k.tolist(), p.tolist())
