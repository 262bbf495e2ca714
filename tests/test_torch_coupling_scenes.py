"""The entry-list floor and full contact coupling beside the assembled
operator (the plain twins of kernels T24 and T23) against the JAX package,
on the CPU, on two scenes of ``tests/coupling_scenes.py``: ``box_entry``
(``create_tet_box`` landing at tick 26, ``dense_floor=False``, collisions
off) and ``mixed_full`` (40 tets under an 8 x 8 sheet, in contact from the
first tick, ``contact_coupling="full"``, the super-body detection, the ELL
and the band under Jacobi).

Tolerances and why:

* ``detect_floor_contacts`` and ``project_static`` (both quirk modes):
  equal;
* the operator with full coupling against ``apply_system``: 1e-6 of the
  largest entry;
* one tick from the JAX state: 3e-6, the contact sets equal as sets; 40
  ticks: ``coupling_scenes.RUN_TOL``, from the JAX package's own float32
  spread, the latch on the same ticks;
* the entry-list box against the port's dense floor, one tick from each
  state of a 40-tick run: 1e-6 (``k·w`` is not ``w+…+w`` in float32; the
  JAX package's own bound, ``tests/test_collisions.py:569``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pies_tpu.collision import batches as jbatches
from pies_tpu_torch import convert
from pies_tpu_torch.collision import batches as tbatches
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import step as tstep
from pies_tpu_torch.solver import tetcols as ttetcols

from coupling_scenes import (
    TICKS,
    forty_ticks_match,
    jax_run,
    np_tree,
    one_tick_matches,
    operator_matches,
    port_solver,
    system,
)
from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

SCENES = ["box_entry", "mixed_full"]


def test_scenes_take_the_generic_path_without_the_block_layout():
    for scene in SCENES:
        t = port_solver(scene)
        assert not ttetcols.applies(t.state, t.topology, t.config), scene
        assert not tpd.block_layout(t.state, t.topology), scene
        assert t.topology.corner_inc is not None


def test_floor_entries_and_projection_equal_jax():
    """``detect_floor_contacts`` and ``project_static`` on the box on the
    floor: equal to the JAX functions; the per-node counts are the dense
    floor's ``floor_count·active``."""
    _, _, (st, topo, params, cfg), _ = jax_run("box_entry")
    thr = float(np.float32(params.floor_height) + np.float32(params.collision_thickness))
    jidx, jmask = jbatches.detect_floor_contacts(st.positions, topo.triangles, topo.tri_mask,
                                                 params.floor_height,
                                                 params.collision_thickness)
    pos = torch.from_numpy(np.array(st.positions))
    idx, mask = tbatches.detect_floor_contacts(pos, torch.from_numpy(np.array(topo.triangles)),
                                               torch.from_numpy(np.array(topo.tri_mask)), thr)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert float(mask.sum()) > 0
    tparams = convert.params_from(np_tree(params))
    for quirks in (True, False):
        ref = jbatches.project_static(st.positions, jidx, params.floor_height, quirks)
        got = tbatches.project_static(pos, idx, tbatches.floor_plane(tparams, quirks))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    t = port_solver("box_entry")
    floor = tpd.default_detect_collisions(pos, t.topology, tparams, t.config)
    dense = tbatches.detect_floor_active(pos, t.topology.floor_count, thr)
    assert torch.equal(floor.floor_counts, t.topology.floor_count * dense)
    assert torch.equal(floor.floor_active, dense)


def test_full_coupling_operator():
    """T23's operator term beside the ELL and the band (in T10's twin)
    against the JAX ``apply_system(contact_coupling="full")``."""
    operator_matches(system("mixed_full"))


@pytest.mark.parametrize("scene", SCENES)
def test_one_tick_from_the_jax_state(scene):
    one_tick_matches(scene)


@pytest.mark.parametrize("scene", SCENES)
def test_forty_ticks_match_reference(scene):
    forty_ticks_match(scene)


@pytest.mark.parametrize("ticks", [40, 80])
def test_entry_list_floor_runs_match_the_dense_floor(ticks):
    """The JAX package's own form (``tests/test_collisions.py:549-569``):
    ``create_tet_box`` at y = 2, collisions off, ``ticks`` ticks on the
    dense floor and as many separate ones on the entry list.  40 ticks, the
    JAX test's: within 1e-6 (measured 0.0), but the box has not reached the
    floor yet (its first floor-active tick is 56 in both packages), so the
    bound says nothing about floor contact.  80 ticks, on the floor: the JAX
    package's own two floors part by more than 1e-6 (8.1e-6) and the port's
    by 2.2e-5, 2.7 times as much; the bound allows four times the JAX gap.
    The early-exit CG amplifies the last-bit difference of ``k·w`` against
    ``w+…+w`` in either package.
    The one-tick form below holds the port to 1e-6 on the floor."""
    import pies_tpu
    import pies_tpu_torch as pt
    from pies_tpu.options import SolverName, SolverOptions

    def run(solver, dense):
        solver.create_tet_box((0, 2.0, 0), 1.0, (0, 0, 0), w=1500.0, mass=1.0)
        solver._prepare()
        solver._config = dataclasses.replace(solver._config, dense_floor=dense)
        counters = None
        if isinstance(solver, pt.Solver):
            counters = solver.counters = tpd.new_counters("cpu")
        first = None
        for tick in range(1, ticks + 1):
            solver.tick()
            if counters is not None and first is None and int(counters["floor_active"]):
                first = tick
        assert not solver.sim_failed
        return solver.get_vertices()["position"][: solver._builder.num_nodes], first

    (dense, first), (entry, _) = (
        run(pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu"), d)
        for d in (True, False))
    gap = np.abs(dense - entry).max()
    if ticks == 40:
        assert gap < 1e-6 and first is None
        return
    jax_gap = np.abs(run(pies_tpu.Solver(SolverOptions(solver=SolverName.PD),
                                         enable_collisions=False), True)[0]
                     - run(pies_tpu.Solver(SolverOptions(solver=SolverName.PD),
                                           enable_collisions=False), False)[0]).max()
    assert first is not None and jax_gap > 1e-6 and gap <= 4.0 * jax_gap, (first, gap, jax_gap)


def test_entry_list_floor_matches_the_dense_floor():
    """The box on the port's dense floor for 40 ticks, and from each tick's
    state one tick on the entry-list floor: within 1e-6 of the dense tick
    (measured 7.2e-7 on the floor, from tick 26; the runs themselves drift
    apart by 3.2e-6 in 14 ticks on the floor, as CG solves stopped by the
    early exit amplify a last-bit difference)."""
    t = port_solver("box_entry", dense_floor=True)
    entry = dataclasses.replace(t.config, dense_floor=False)
    counters = tpd.new_counters("cpu")
    err = 0.0
    for _ in range(TICKS):
        st = dataclasses.replace(t.state, **{
            f.name: getattr(t.state, f.name).clone() for f in dataclasses.fields(t.state)
            if isinstance(getattr(t.state, f.name), torch.Tensor)})
        tstep.tick(st, t.topology, t.current_params(), entry, counters=counters)
        t.tick()
        err = max(err, float((st.positions - t.state.positions).abs().max()))
    assert int(counters["floor_active"]) > 0 and not t.sim_failed
    assert err < 1e-6, err
