"""The port's PD node-node contacts (kernel T20's pair prefix in its
always-rebuild form and the plain twins of kernel T27) against the JAX
package, on the CPU.

Scenes: the node pile of ``scripts/bench_all.py`` at 512 nodes
(``scene/pbd_scenes.add_node_pile``) under the PD solver with
``enable_node_collisions=True``; the two-sphere and friction cases of
``tests/test_collisions.py:494-547``; a 24-tet soup with node-node contacts,
which leaves the tet-column path in both packages.

Tolerances and why:

* the pairs (``nn_idx``, ``nn_mask``) with a cap below the pair count, on
  identical inputs: equal, in order;
* one tick from the JAX state: 3e-6, as every slice;
* 20 ticks of the pile: ``PILE_RUN_TOL``, from the JAX package's own
  float32 spread on that run, the latch on the same ticks.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision.broadphase import detect_node_node_pairs as jdetect
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.options import StepConfig as JConfig
from pies_tpu.solver.step import tick as jtick
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.collision import broadphase as tb
from pies_tpu_torch.collision.batches import node_pairs_of
from pies_tpu_torch.scene.pbd_scenes import add_node_pile
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import step as tstep
from pies_tpu_torch.solver import tetcols as ttetcols

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

STEP_TOL = 3e-6
PILE_N = 512
PILE_CAP = 1 << 14  # above the pile's pair count: every pair is live
# 20 ticks of the pile: the JAX package's own spread (12 runs started one
# to four ulps away) is 9.0e-5 to 0.26 (once two runs part, a pair crosses
# the touching test on another tick), median 1.6e-4; the port parts from it
# by 1.2e-4.
PILE_RUN_TOL = 1e-3

_jdetect = jax.jit(jdetect, static_argnames=("config",))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _args(cap=PILE_CAP, **kw):
    return dict(enable_collisions=False, enable_node_collisions=True,
                budget_overrides=dict(max_node_node_contacts=cap), **kw)


def _jax_pile(cap=PILE_CAP):
    j = add_node_pile(pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0,
                                      **_args(cap)), PILE_N)
    j._prepare()
    return j


def _port_pile(cap=PILE_CAP):
    t = add_node_pile(pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), device="cpu",
                                **_args(cap)), PILE_N)
    t._prepare()
    return t


def _carry(j):
    return (convert.state_from_numpy(_np(j._state)),
            convert.topology_from_numpy(_np(j._topology)), convert.config_from(j._config),
            convert.params_from(_np(j.current_params())))


def test_config_from_carries_the_contact_flags():
    """``convert.config_from`` carries ``enable_edge_collisions`` and
    ``enable_node_collisions`` across (the shared fields by name)."""
    for edge, node in ((True, False), (False, True), (True, True)):
        cfg = convert.config_from(JConfig(enable_edge_collisions=edge,
                                          enable_node_collisions=node))
        assert (cfg.enable_edge_collisions, cfg.enable_node_collisions) == (edge, node)


def test_node_pairs_equal_reference():
    """The pile's pairs after 3 ticks, with a cap of 256 (below the pair
    count): ``nn_idx`` and ``nn_mask`` equal the JAX package's."""
    j = _jax_pile(256)
    for _ in range(3):
        j.tick()
    s, p = j._state, j.current_params()
    x = s.positions + p.dt * s.velocities * s.node_mask[:, None]
    ji, jm = _jdetect(s, x, p, config=j._config)
    ts, _, cfg, params = _carry(j)
    nn = tb.detect_node_node_pairs(torch.from_numpy(np.array(x)), ts.radius, ts.node_mask,
                                   params, cfg, ts.sim_failed, plain=True)
    assert int(nn.count[0]) > 256
    ti, tm = node_pairs_of(nn, cfg.budget.max_node_node_contacts)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("cap", [256, PILE_CAP])
def test_one_tick_of_the_pile_matches_reference(cap):
    """From the JAX state after 5 ticks, one port tick lands within 3e-6
    of the JAX tick, with live and touching pairs."""
    j = _jax_pile(cap)
    for _ in range(5):
        j.tick()
    ts, topo, cfg, params = _carry(j)
    c = tpd.new_counters("cpu")
    tstep.tick(ts, topo, params, cfg, counters=c)
    ref, _ = jtick(j._state, j._topology, j.current_params(), j._config)
    err = float(np.abs(ts.positions.numpy()[:PILE_N] - np.asarray(ref.positions)[:PILE_N]).max())
    assert err <= STEP_TOL, err
    assert int(c["node_pairs"]) > 0 and int(c["touching_pairs"]) > 0
    assert ts.failed() == bool(ref.sim_failed) == False  # noqa: E712


def test_twenty_ticks_of_the_pile_match_reference():
    """20 ticks through both packages' ``Solver``: positions within
    ``PILE_RUN_TOL``, the latch on the same ticks (never)."""
    ticks = 20
    j, t = _jax_pile(), _port_pile()
    ref, pos, ref_failed, failed = [], [], [], []
    t.counters = tpd.new_counters("cpu")
    for _ in range(ticks):
        j.tick()
        t.tick()
        ref.append(np.asarray(j._state.positions)[:PILE_N])
        pos.append(t.state.positions[:PILE_N].numpy().copy())
        ref_failed.append(bool(j._state.sim_failed))
        failed.append(t.sim_failed)
    assert failed == ref_failed == [False] * ticks
    assert int(t.counters["touching_pairs"]) > 0
    err = float(np.abs(np.stack(pos) - np.stack(ref)).max())
    assert err <= PILE_RUN_TOL, err


def test_two_spheres_pushed_apart():
    """``tests/test_collisions.py:498-523`` on the port: two overlapping
    free spheres stay interpenetrated without the contacts and are pushed
    toward the radius sum with them; both packages' positions agree."""
    def run(package, enable):
        opts = dict(solver=JName.PD if package is pies_tpu else pt.SolverName.PD, gravity=0.0,
                    iterations=8, collision_stabilization_iterations=0)
        kw = dict(enable_collisions=False, enable_node_collisions=enable, cg_iterations=32)
        if package is pies_tpu:
            s = pies_tpu.Solver(JOptions(**opts), dense_operator_max=0, **kw)
        else:
            s = pt.Solver(pt.SolverOptions(**opts), device="cpu", **kw)
        s.add_nodes(np.array([[0, 5, 0], [0.5, 5, 0]], np.float32))
        for _ in range(20):
            s.tick()
        assert not s.sim_failed
        return np.asarray(s.get_vertices()["position"][:2])

    off, on = run(pt, False), run(pt, True)
    assert abs(float(np.linalg.norm(off[1] - off[0])) - 0.5) < 1e-3
    assert float(np.linalg.norm(on[1] - on[0])) > 0.95
    np.testing.assert_allclose(on, run(pies_tpu, True), atol=1e-5)


def test_friction_damps_relative_sliding():
    """``tests/test_collisions.py:525-547`` on the port: identical touching
    pairs sliding tangentially end one tick with less relative tangential
    velocity under friction 0.5 than under 0; the port's velocities equal
    the JAX package's to 1e-5."""
    def run(friction, package=pt):
        if package is pies_tpu:
            s = pies_tpu.Solver(JOptions(solver=JName.PD, gravity=0.0, friction=friction,
                                         collision_stabilization_iterations=0),
                                enable_collisions=False, enable_node_collisions=True,
                                dense_operator_max=0)
        else:
            s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD, gravity=0.0,
                                           friction=friction,
                                           collision_stabilization_iterations=0),
                          enable_collisions=False, enable_node_collisions=True, device="cpu")
        s.add_nodes(np.array([[0, 5, 0], [0.6, 5, 0]], np.float32))
        s._prepare()
        if package is pies_tpu:
            s._state = dataclasses.replace(
                s._state, velocities=s._state.velocities.at[1, 1].set(2.0))
        else:
            s._state.velocities[1, 1] = 2.0
        s.tick()
        return np.asarray(s._state.velocities[:2])

    v_half, v_zero = run(0.5), run(0.0)
    assert abs(v_half[1, 1] - v_half[0, 1]) < abs(v_zero[1, 1] - v_zero[0, 1]) - 0.1
    np.testing.assert_allclose(v_half, run(0.5, pies_tpu), atol=1e-5)


def test_soup_with_node_contacts_matches_reference():
    """A 24-tet soup with node-node contacts leaves the tet-column path
    (``tetcols.py:82-83``) in the port as in the JAX package; one tick from
    the JAX state after 3 ticks lands within 3e-6 of the JAX tick."""
    kw = dict(enable_node_collisions=True)
    j = pies_tpu.Solver(JOptions(), dense_operator_max=0, **kw)
    j.create_tet_soup(24, spacing=1.6, scale=0.8, w=2000.0)
    j._prepare()
    for _ in range(3):
        j.tick()
    ts, topo, cfg, params = _carry(j)
    assert not ttetcols.applies(ts, topo, cfg)
    c = tpd.new_counters("cpu")
    tstep.tick(ts, topo, params, cfg, counters=c)
    ref, _ = jtick(j._state, j._topology, j.current_params(), j._config)
    n = j._builder.num_nodes
    err = float(np.abs(ts.positions.numpy()[:n] - np.asarray(ref.positions)[:n]).max())
    assert int(c["node_pairs"]) > 0
    assert err <= STEP_TOL, err
