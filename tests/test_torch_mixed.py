"""The slice as a whole against the JAX package, through both packages'
``Solver`` on the CPU: self-contact on the generic PD path (the super-body
detection, recentered contact coupling, the banded tet operator).  Every
scene runs with ``allpairs_broadphase_max=0`` so that its small size takes
the super-body path; the JAX package with ``dense_operator_max=0`` so that
both run Jacobi-PCG.

Tolerances and why:

* the mixed mini scene (40 tets, an 8 × 8 sheet at y = 2.2, three live
  cloth-soup contacts from the first tick, the soup on the floor from tick
  24), 40 ticks: contact counts and the latch equal on every tick, the
  first tick within 1e-5 (measured 4.8e-7), the trajectory within 5e-3.
  Measured: the port parts from the JAX package by 1.0e-4 up to tick 33 and
  by 2.3e-3 at tick 40; a tet that has just come to rest on the floor takes
  another branch of its local step under a perturbation of one rounding.
  The JAX package's own float32 spread on this scene, six runs with half of
  the initial coordinates moved by one float32 ulp against the unmoved one,
  is 8.6e-5 to 3.2e-3 at tick 40 (the same event, hit by three of the six).
* the flat 10 × 10 sheet landing on the floor, 60 ticks
  (``tests/test_collisions.py:868-902``): no latch in either package, no
  contact, within 1e-4 (measured 2.0e-5);
* the 1,331-node mesh, 12 ticks with collisions on and off in the port: no
  contact, so the positions are equal bit for bit (a zero contact diagonal
  and a zero contact force add exactly nothing);
* a JAX run of the mixed scene with the sheet at y = 3.2, carried across at
  tick 44 (contacts live since tick 42) with ``convert.py``, then one tick
  in each package: the same six contacts, the same cache, positions within
  1e-5 (measured 4.8e-7).  The JAX package ticks with ``unroll_loops=False``
  as ``solvers`` runs it for the other scenes, so that the tick compiled for
  the mixed scene serves this run too (unrolled: the same six contacts from
  tick 42, one tick within 9.5e-7).
"""

import dataclasses

import numpy as np
import torch

import pies_tpu
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.scene.mixed_drape import add_mixed_drape
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import step as tstep
from pies_tpu_torch.solver import tetcols as ttetcols

from test_torch_super import _jax_detect, _np, build, solvers
from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

STEP_TOL, MIXED_TOL, CLOTH_TOL = 1e-5, 5e-3, 1e-4


def _jax_contacts(j):
    """The contacts the JAX package's next tick detects (the same
    deterministic detection on the same inputs)."""
    s = j._state
    x = s.positions + j.current_params().dt * s.velocities * s.node_mask[:, None]
    pt_idx, pt_mask, _, _ = _jax_detect(j, x, s.bp)
    live = np.asarray(pt_mask) > 0
    return np.asarray(pt_idx)[live]


def _run_both(j, t, ticks):
    n = t._builder.num_nodes
    ref, port, ref_counts, counts, trips = [], [], [], [], []
    for _ in range(ticks):
        ref_counts.append(len(_jax_contacts(j)))
        t.counters = tpd.new_counters("cpu")
        j.tick()
        t.tick()
        counts.append(int(t.counters["contacts"]))
        trips.append(int(t.counters["cg_trips"]))
        assert t.sim_failed == j.sim_failed
        ref.append(np.asarray(j._state.positions)[:n])
        port.append(t.state.positions[:n].numpy().copy())
    return np.stack(ref), np.stack(port), ref_counts, counts, trips


def test_mixed_slice_matches_reference():
    j, t = solvers("mixed")
    assert not ttetcols.applies(t.state, t.topology, t.config)  # the generic path
    assert t.config.super_packed_k == 40 and t.config.contact_coupling == "recentered"
    ref, port, ref_counts, counts, _ = _run_both(j, t, 40)
    assert counts == ref_counts and min(counts) > 0
    assert not t.sim_failed
    assert np.abs(port[0] - ref[0]).max() <= STEP_TOL
    assert np.abs(port - ref).max() <= MIXED_TOL
    assert port[-1, :160, 1].min() < 0.05  # the soup reached the floor
    # Every contact is a soup node against a sheet triangle.
    idx = _jax_contacts(j)
    assert (idx[:, 0] < 160).all() and (idx[:, 1:] >= 160).all()


def test_pure_loose_cloth_lands_without_a_latch():
    j, t = solvers("cloth")
    assert t.config.super_packed_k == 0 and t.config.super_k == 168
    ref, port, ref_counts, counts, _ = _run_both(j, t, 60)
    assert not t.sim_failed and not j.sim_failed
    assert counts == ref_counts
    assert np.abs(port - ref).max() <= CLOTH_TOL
    assert port[-1, :, 1].min() > -0.1 and port[-1, :, 1].max() < 0.2  # it lies on the floor


def test_no_contact_equals_collisions_off():
    """The mesh falls freely for 12 ticks: with self-contact on, detection
    runs every tick and finds nothing, and the positions equal the
    collisions-off run's bit for bit."""
    kw = dict(device="cpu", allpairs_broadphase_max=0)
    on = build(pt.Solver(pt.SolverOptions(), enable_collisions=True, **kw), "mesh")
    off = build(pt.Solver(pt.SolverOptions(), enable_collisions=False, **kw), "mesh")
    assert on.config.super_k > 0 and on.state.bp is not None and off.state.bp is None
    on.counters = tpd.new_counters("cpu")
    for _ in range(12):
        on.tick()
        off.tick()
    assert int(on.counters["contacts"]) == 0 and int(on.counters["rebuilds"]) > 0
    assert not on.sim_failed
    assert torch.equal(on.state.positions, off.state.positions)
    assert torch.equal(on.state.velocities, off.state.velocities)


def test_converter_carries_a_mixed_run_across():
    """44 JAX ticks of the mixed scene with its sheet at y = 3.2 (sheet and
    soup touch from tick 42), carried across with convert.py (the super-body
    tables, the band, the cache), then one more tick in each package."""
    j = pies_tpu.Solver(JOptions(solver=JName.PD), allpairs_broadphase_max=0,
                        dense_operator_max=0)
    add_mixed_drape(j, 40, 8)
    j._prepare()
    # (the PD iterations as a fori_loop, as ``solvers`` runs the JAX
    # package: the tick the mixed scene compiled serves this run)
    j._config = dataclasses.replace(j._config, unroll_loops=False)
    for _ in range(44):
        j.tick()
    st = convert.state_from_numpy(_np(j._state))
    topo = convert.topology_from_numpy(_np(j._topology))
    cfg = convert.config_from(j._config)
    params = convert.params_from(_np(j.current_params()))
    assert cfg.super_k == j._config.super_k > 0 and topo.super_corners is not None
    assert tuple(st.bp.ref.shape) == (st.capacity, 3)
    expected = _jax_contacts(j)
    assert len(expected) > 0
    # The port's detection on the carried state finds the same contacts.
    head = tpd.substep_head_plain(convert.state_from_numpy(_np(j._state)), topo, params, cfg,
                                  True)
    colls = tpd.detect_point_tri(convert.state_from_numpy(_np(j._state)), head[0], topo,
                                 params, cfg, head[4])
    np.testing.assert_array_equal(colls.pt_idx[: int(colls.pt_count[0])].numpy(), expected)
    counters = tpd.new_counters("cpu")
    tstep.tick(st, topo, params, cfg, counters=counters)
    j.tick()
    assert int(counters["contacts"]) == len(expected)
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(j._state.positions),
                               atol=STEP_TOL, rtol=0)
    ref = convert.cache_from_numpy(_np(j._state.bp))
    for f in ("pairs", "valid", "ref", "fresh"):
        assert torch.equal(getattr(st.bp, f), getattr(ref, f)), f
    assert not st.failed() and not j.sim_failed
