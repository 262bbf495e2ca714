"""Ticks of the port's edge-edge contacts (the plain twins of kernels T25
and T26, through ``pd_substep``'s generic path) against the JAX package,
on the CPU, on the scenes of ``tests/test_torch_edges.py``: the crossing
strips under full and recentered coupling and both quirk modes, and the
6 x 6 crossing nets under full coupling; and the contact cap's truncation
on the nets.

Tolerances and why:

* the truncated contacts on the nets at tick 65 with a cap of 256: equal;
* one tick of the strips from the JAX state: 3e-6;
* one tick of the nets from the JAX state at tick 20 (live edge contacts,
  the PCG at its 16-trip cap): the JAX package's own one-tick spread there,
  the farthest its tick moves from states one ulp away (half the
  coordinates, four seeds; 2.8e-5 to 4.2e-5 measured), or 3e-6 where that
  is smaller: with w = 1e6 contacts and an unconverged PCG a rounding of
  the inputs moves the tick ten times 3e-6;
* 30 ticks of the nets: ``NETS_RUN_TOL``, from the JAX package's own
  float32 spread on that run; the latch on the same ticks through tick 65,
  where both packages latch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pies_tpu.solver.step import tick as jtick
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.scene.edge_nets import add_crossing_nets
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import step as tstep

from test_torch_edges import (NETS_NN, _detect_both, _jax_nets_at, _jax_nets_states,
                              _jax_strips, _nets_args)
from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

STEP_TOL = 3e-6
# 30 ticks of the 6 x 6 nets under full coupling: the JAX package's own
# spread (12 runs started one to four ulps away) is 1.9e-4 to 1.9e-2,
# median 3.0e-4; the port parts from it by 2.0e-4.
NETS_RUN_TOL = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# ticks


def _carry(j):
    return (convert.state_from_numpy(_np(j._state)),
            convert.topology_from_numpy(_np(j._topology)), convert.config_from(j._config),
            convert.params_from(_np(j.current_params())))


def _one_tick(j):
    ts, topo, cfg, params = _carry(j)
    c = tpd.new_counters("cpu")
    tstep.tick(ts, topo, params, cfg, counters=c)
    ref, _ = jtick(j._state, j._topology, j.current_params(), j._config)
    n = j._builder.num_nodes
    err = float(np.abs(ts.positions.numpy()[:n] - np.asarray(ref.positions)[:n]).max())
    assert ts.failed() == bool(ref.sim_failed) == False  # noqa: E712
    return err, {k: int(v) for k, v in c.items()}


@pytest.mark.parametrize("coupling", ["full", "recentered"])
@pytest.mark.parametrize("quirks", [False, True], ids=["fixed", "quirks"])
def test_one_tick_of_the_strips_matches_reference(coupling, quirks):
    """One tick of the strips from the JAX state, with live edge contacts:
    within 3e-6 of the JAX tick."""
    err, c = _one_tick(_jax_strips(quirks, coupling))
    assert c["edge_contacts"] > 0
    assert err <= STEP_TOL, err


def _one_tick_spread(j, seeds=4):
    """The farthest the JAX tick from ``j``'s state moves when half the live
    coordinates move one ulp up or down."""
    ref, _ = jtick(j._state, j._topology, j.current_params(), j._config)
    n = j._builder.num_nodes
    out = 0.0
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        p = np.array(j._state.positions)
        sel = rng.random(p.shape) < 0.5
        sel[n:] = False
        q = np.nextafter(p, np.where(rng.random(p.shape) < 0.5, np.float32(np.inf),
                                     np.float32(-np.inf)))
        st = dataclasses.replace(j._state, positions=jnp.asarray(np.where(sel, q, p)))
        o, _ = jtick(st, j._topology, j.current_params(), j._config)
        out = max(out, float(np.abs(np.asarray(o.positions)[:n]
                                    - np.asarray(ref.positions)[:n]).max()))
    return out


def test_one_tick_of_the_nets_matches_reference():
    """One tick of the nets from the JAX state at tick 20 (live edge
    contacts, full coupling): within the JAX tick's own one-ulp spread
    there (or 3e-6)."""
    j = _jax_nets_at(False, 20)
    err, c = _one_tick(j)
    assert c["edge_contacts"] > 0
    tol = max(STEP_TOL, _one_tick_spread(j))
    assert err <= tol, (err, tol)


def test_the_nets_match_reference_and_latch_on_its_tick():
    """65 ticks through both packages' ``Solver``: positions within
    ``NETS_RUN_TOL`` over the first 30, edge contacts in them, and the latch
    on the same ticks: none before tick 65, where the contact caps fill and
    both packages latch."""
    ticks, compared = 65, 30
    _, states = _jax_nets_states(False, 65)
    n = 2 * NETS_NN * NETS_NN
    ref = np.stack([np.asarray(st.positions)[:n] for st in states[1: compared + 1]])
    ref_failed = [bool(st.sim_failed) for st in states[1: ticks + 1]]
    t = add_crossing_nets(pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), device="cpu",
                                    **_nets_args()), NETS_NN)
    t.counters = tpd.new_counters("cpu")
    pos, failed = [], []
    for k in range(ticks):
        t.tick()
        if k < compared:
            pos.append(t.state.positions[:n].numpy().copy())
        if k + 1 == compared:
            assert int(t.counters["edge_contacts"]) > 0
        failed.append(t.sim_failed)
    assert failed == ref_failed == [False] * (ticks - 1) + [True]
    err = float(np.abs(np.stack(pos) - ref).max())
    assert err <= NETS_RUN_TOL, err


def test_edge_cap_drops_hits_past_it_like_reference():
    """The nets' detection of tick 65 (from the state after tick 64: over a
    thousand hits) with ``max_edge_contacts = 256``: the truncated prefix
    equals the JAX package's, no latch from the edges, and the port counts
    the hits before the cap."""
    j = _jax_nets_at(False, 64)
    cfg = dataclasses.replace(
        j._config, budget=dataclasses.replace(j._config.budget, max_edge_contacts=256))
    count, hits = _detect_both(j, cfg)
    assert count == 256 < hits
