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
