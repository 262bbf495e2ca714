"""The port's edge-edge contacts (the plain twins of kernels T25 and T26)
against the JAX package, on the CPU.

Scenes: the crossing strips of ``tests/test_collisions.py:254-300`` (two
free triangles whose bottom edges cross 0.05 apart, the upper one moving
down), a variant whose first corners lie 0.25 apart (the quirk-mode CCD
tests proximity at u = v = 0, so only such pairs hit under
``reference_quirks=True``), and the 6 x 6 crossing nets of
``scripts/bench_all.py``'s ``edge_nets`` at its small size
(``scene/edge_nets.py``).

Tolerances and why:

* the device functions (``segment_closest_uv``, ``edge_edge_ccd``, the
  projection and the stabilization accumulator) on seeded inputs: the CCD's
  hits equal, the rest within 1e-6 of the largest value (XLA fuses and
  orders the row sums its own way);
* detection (``edge_idx``, ``edge_mask``, the overflow flag) on identical
  inputs, made by the JAX package's ticks: equal, in order, both quirk
  modes, and the cap's prefix equal.  On the nets under the quirks the JAX
  detection runs op by op: the nets hold exactly parallel edge pairs (a
  strand of one net and a diagonal of the other), whose parallel test
  ``det == 0`` XLA's fused rounding decides otherwise, and in quirk mode
  that flips the pair's proximity test; op by op it rounds as the port
  does.

The cap's truncation and the ticks are in ``tests/test_torch_edge_ticks.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision import batches as jbatches
from pies_tpu.collision import narrowphase as jnarrow
from pies_tpu.collision.broadphase import detect_edge_edge_collisions as jdetect
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.collision import batches as tbatches
from pies_tpu_torch.collision import broadphase as tb
from pies_tpu_torch.collision import narrowphase as tnarrow
from pies_tpu_torch.scene.edge_nets import add_crossing_nets, solver_args
from pies_tpu_torch.solver import tetcols as ttetcols

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

NETS_NN = 6



def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# scenes


def _strips(s, quirk_geometry=False):
    """Two free triangles: the crossing strips, or with ``quirk_geometry``
    the pair whose first corners lie 0.25 apart; the second one moves down
    at 2 units per second."""
    b = s._builder
    t1 = b._emit_nodes(np.array([[-1, 1, 0], [1, 1, 0], [0, 2.5, 0]], np.float32),
                       inv_mass=1.0, radius=0.1)
    top = ([[-0.9, 1.2, -0.1], [0.9, 1.2, 1.0], [0.1, 2.6, 0.8]] if quirk_geometry
           else [[0, 1.05, -1], [0, 1.05, 1], [0, 2.5, 0.8]])
    t2 = b._emit_nodes(np.array(top, np.float32), velocity=(0.0, -2.0, 0.0), inv_mass=1.0,
                       radius=0.1)
    b.triangles.append(t1[None, :])
    b.triangles.append(t2[None, :])
    s._dirty = True
    return s


def _strips_args(quirks, coupling):
    return dict(enable_collisions=False, enable_edge_collisions=True,
                reference_quirks=quirks, contact_coupling=coupling)


def _jax_strips(quirks, coupling="recentered"):
    j = _strips(pies_tpu.Solver(JOptions(solver=JName.PD, gravity=0.0), dense_operator_max=0,
                                **_strips_args(quirks, coupling)), quirk_geometry=quirks)
    j._prepare()
    return j


def _nets_args(quirks=False, caps=2048):
    kw = solver_args(caps)
    kw["reference_quirks"] = quirks
    return kw


@functools.lru_cache(maxsize=None)
def _jax_nets_states(quirks, ticks):
    """The JAX package's nets after 0, 1, ..., ``ticks`` ticks."""
    j = add_crossing_nets(pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0,
                                          **_nets_args(quirks)), NETS_NN)
    j._prepare()
    states = [j._state]
    for _ in range(ticks):
        j.tick()
        states.append(j._state)
    return j, states


def _jax_nets_at(quirks, tick):
    j, states = _jax_nets_states(quirks, 65 if not quirks else 30)
    j._state = states[tick]
    return j


# ---------------------------------------------------------------------------
# the device functions on seeded inputs


def _rows(rng, n, scale=1.0):
    return (rng.standard_normal((n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("quirks", [False, True], ids=["fixed", "quirks"])
def test_edge_functions_match_reference(quirks):
    """``segment_closest_uv`` and ``edge_edge_ccd`` (hits equal), the
    projection and the stabilization accumulator, on seeded segment pairs
    (a quarter of them parallel) against the JAX functions."""
    rng = np.random.default_rng(5)
    n = 512
    ab0, ac0, ad0 = _rows(rng, n), _rows(rng, n), _rows(rng, n)
    move = lambda v: (v + _rows(rng, n, 0.3)).astype(np.float32)  # noqa: E731
    ab1, ac1, ad1 = move(ab0), move(ac0), move(ad0)
    par = np.arange(n) % 4 == 0
    ad1[par] = ac1[par] + 0.5 * ab1[par]
    cols = lambda v: tnarrow._cols(torch.from_numpy(v))  # noqa: E731
    u, v, deg = tnarrow.segment_closest_uv(cols(ab1), cols(ac1), cols(ad1))
    ju, jv, jdeg = jnarrow._segment_closest_uv(jnp.asarray(ab1), jnp.asarray(ac1),
                                               jnp.asarray(ad1))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6)
    hit = tnarrow.edge_edge_ccd(*(cols(a) for a in (ab0, ac0, ad0, ab1, ac1, ad1)),
                                quirk=quirks)
    jhit, _ = jnarrow.edge_edge_ccd(*(jnp.asarray(a) for a in (ab0, ac0, ad0, ab1, ac1, ad1)),
                                    quirk=quirks)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert 0 < int(hit.sum()) < n

    # Projection and stabilization: 64 contacts over 96 nodes, close pairs.
    m = 96
    x = (rng.uniform(0.0, 1.0, (m, 3)) * np.float32([1.2, 0.2, 1.2])).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, m).astype(np.float32)
    inv_mass[:4] = 0.0
    idx = np.stack([rng.choice(m, 4, replace=False) for _ in range(64)]).astype(np.int32)
    mask = (rng.random(64) < 0.9).astype(np.float32)
    thickness = np.float32(0.3)
    proj, delta = tbatches.project_edge_edge(_t(x), _t(inv_mass), _t(idx), float(thickness),
                                             quirks)
    jproj, jdelta = jbatches.project_edge_edge(jnp.asarray(x), jnp.asarray(inv_mass),
                                               jnp.asarray(idx), thickness, quirks)
    np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), atol=1e-6)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), atol=1e-6)
    assert float(delta.abs().max()) > 0.0
    acc = tbatches.stabilize_edge_edge_acc(_t(x), _t(inv_mass), _t(idx), _t(mask),
                                           float(thickness), quirks)
    jacc = jbatches.stabilize_edge_edge_acc(jnp.asarray(x), jnp.asarray(inv_mass),
                                            jnp.asarray(idx), jnp.asarray(mask), thickness,
                                            quirks)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), atol=1e-6)


# ---------------------------------------------------------------------------
# detection


_jdetect = jax.jit(jdetect, static_argnames=("config",))


def _detect_both(j, cfg_j=None, eager=False):
    """Edge detection of both packages on the JAX solver's next-substep
    inputs (the JAX one op by op with ``eager``); asserts ``edge_idx``,
    ``edge_mask`` and the overflow flag equal and returns the port's
    ``(count, hits)``."""
    s, p = j._state, j.current_params()
    cfg_j = cfg_j or j._config
    x = s.positions + p.dt * s.velocities * s.node_mask[:, None]
    topo = j._topology
    if eager:
        with jax.disable_jit():
            ji, jm, jo = jdetect(x, s.prev_positions, topo.triangles, topo.tri_mask, p, cfg_j)
    else:
        ji, jm, jo = _jdetect(x, s.prev_positions, topo.triangles, topo.tri_mask, p,
                              config=cfg_j)
    cfg, params = convert.config_from(cfg_j), convert.params_from(_np(p))
    ov = torch.zeros(1, dtype=torch.int32)
    ti, tm, tc, th = tb.detect_edge_edge_collisions(
        _t(x), _t(s.prev_positions), _t(topo.triangles), _t(topo.tri_mask), params, cfg, ov,
        plain=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tc[0]) == int(np.asarray(jm).sum())
    assert bool(ov[0]) == bool(jo)
    return int(tc[0]), int(th[0])


@pytest.mark.parametrize("scene,quirks", [("strips", False), ("strips", True),
                                          ("nets20", False), ("nets30", False),
                                          ("nets20", True), ("nets30", True)])
def test_edge_detection_equals_reference(scene, quirks):
    """``edge_idx``, ``edge_mask`` and the overflow flag equal the JAX
    package's, in order, on the strips and on the nets at ticks 20 and 30,
    under both quirk modes; every case has contacts."""
    j = (_jax_strips(quirks) if scene == "strips"
         else _jax_nets_at(quirks, int(scene[4:])))
    count, hits = _detect_both(j, eager=quirks and scene != "strips")
    assert count == hits > 0


def test_edge_detection_on_the_full_nets_equals_reference():
    """``edge_nets`` at its full nn = 24 (1,152 nodes, the cell of
    ``chip_smoke.py`` phase 12a): both detections on the port's own states
    after ticks 3, 4 and 5, and on the tick-3 state with every live
    coordinate moved by a seeded amount under 1e-6; ``edge_idx``,
    ``edge_mask`` and the overflow flag equal (the JAX detection op by op).
    The port's run finds edge contacts from its tick-3 prediction on.  The
    flat nets lie near the CCD's threshold there, so the moved state may
    find another count; both detections must decide it alike on each
    input."""
    t = add_crossing_nets(pt.Solver(pt.SolverOptions(), device="cpu", **_nets_args()), 24)
    j = add_crossing_nets(pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0,
                                          **_nets_args()), 24)
    j._prepare()
    p, topo, cfg_j = j.current_params(), j._topology, j._config
    cfg, params = convert.config_from(cfg_j), convert.params_from(_np(p))
    n = t._builder.num_nodes

    def both(x, prev):
        with jax.disable_jit():
            ji, jm, jo = jdetect(jnp.asarray(x), jnp.asarray(prev), topo.triangles,
                                 topo.tri_mask, p, cfg_j)
        ov = torch.zeros(1, dtype=torch.int32)
        ti, tm, tc, _ = tb.detect_edge_edge_collisions(
            _t(x), _t(prev), _t(topo.triangles), _t(topo.tri_mask), params, cfg, ov, plain=True)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert bool(ov[0]) == bool(jo)
        return int(tc[0])

    counts = {}
    t.run_ticks(2)
    for tick in (3, 4, 5):
        t.tick()
        st = t.state
        x = (st.positions + params.dt * st.velocities * st.node_mask[:, None]).numpy()
        counts[tick] = both(x, st.prev_positions.numpy())
        if tick == 3:
            moved = x.copy()
            moved[:n] += np.random.default_rng(0).uniform(-1e-6, 1e-6, (n, 3)).astype(np.float32)
            counts["moved"] = both(moved, st.prev_positions.numpy())
    assert counts[3] > 0, counts


def test_edge_contacts_take_the_generic_path():
    """A tet soup with edge-edge contacts leaves the tet-column path
    (``tetcols.py:82-83``: its triangles make the edge buffer); one without
    triangles-side edge detection keeps it."""
    s = pt.Solver(pt.SolverOptions(), enable_edge_collisions=True, device="cpu")
    s.create_tet_soup(8, spacing=1.6, scale=0.8, w=2000.0)
    assert not ttetcols.applies(s.state, s.topology, s.config)
    s = pt.Solver(pt.SolverOptions(), device="cpu")
    s.create_tet_soup(8, spacing=1.6, scale=0.8, w=2000.0)
    assert ttetcols.applies(s.state, s.topology, s.config)
