"""The port's PBD solver (the plain twins of kernels T18-T21) against the JAX
package, on the CPU.

Inputs come from numpy seeds and the builders, which are the same code in
both packages; states cross with ``pies_tpu_torch.convert``.  Each device
function of the slice is held to its JAX counterpart on identical inputs:
the Jacobi families (``_apply_jacobi``), the chain walk and the colour
classes (through ``pbd_substep`` with everything else switched off), the
node-pair candidates and prefix (exactly equal) and the pair response
(1e-6).  One tick from a JAX state lands within 3e-6 of the JAX tick on
every scene of the slice; 40 ticks through both packages' ``Solver`` stay
within a bound set from the JAX package's own float32 spread
(:func:`jax_spread`), with the pair cache rebuilt on the same ticks and the
latch on the same ticks.  Also: ``release_hinge`` toggled mid-run, the
node-pair cache checks of ``tests/test_collisions.py`` on the port, and
checkpoints crossing between the packages.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision import broadphase as jbp
from pies_tpu.constraints import projections as jproj
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.solver import pbd as jpbd
from pies_tpu.solver.step import default_detect_node_pairs as jdetect
from pies_tpu.solver.step import tick as jtick
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.collision import broadphase as tb
from pies_tpu_torch.constraints import projections as tproj
from pies_tpu_torch.scene.pbd_scenes import add_net, add_node_pile, add_rope_fleet
from pies_tpu_torch.solver import pbd as tpbd
from pies_tpu_torch.solver import step as tstep

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

STEP_TOL = 3e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def rope(s):
    """``scripts/bench_all.py:59-72`` at its small size: 2 ropes of 128."""
    return add_rope_fleet(s, 256)


def pile(s):
    """``scripts/bench_all.py:168-175`` at its small size: 512 nodes on the
    bench's 8 x 8 floor."""
    return add_node_pile(s, 512, half=4.0)


def box(s):
    s.create_box((0.0, 3.0, 0.0), 1.0, 0.5)
    return s


def tet_box(s):
    s.create_tet_box((0.0, 3.0, 0.0), 1.0, (0, 0, 0), w=0.1, mass=1.0)
    return s


def bend_sheet(s):
    s.create_bend_sheet((0, 2.0, 0), 0.5, w=0.1)
    return s


# scene -> (builder, Solver arguments beside the PBD options)
SCENES = {
    "rope": (rope, dict(enable_collisions=True)),
    "pile": (pile, dict(enable_collisions=True)),
    "net": (add_net, dict(enable_collisions=False)),
    "box": (box, dict(enable_collisions=True)),
    "tet_box_quirks": (tet_box, dict(enable_collisions=False, reference_quirks=True)),
    "tet_box_fixed": (tet_box, dict(enable_collisions=False, reference_quirks=False)),
    "bend_sheet": (bend_sheet, dict(enable_collisions=False)),
}


def _jax(scene):
    build, kw = SCENES[scene]
    j = build(pies_tpu.Solver(JOptions(solver=JName.PBD), **kw))
    j._prepare()
    return j


def _port(scene):
    build, kw = SCENES[scene]
    t = build(pt.Solver(pt.SolverOptions(solver=pt.SolverName.PBD), device="cpu", **kw))
    t._prepare()
    return t


def _carry(j):
    """The JAX solver's state, topology, config and params on the port."""
    return (convert.state_from_numpy(_np(j._state)), convert.topology_from_numpy(_np(j._topology)),
            convert.config_from(j._config), convert.params_from(_np(j.current_params())))


# ---------------------------------------------------------------------------
# host: the distance form, the chains and the colour classes


@pytest.mark.parametrize("scene", ["rope", "net", "box", "pile"])
def test_host_picks_the_jax_distance_form(scene):
    """Chains for ropes, colour classes for the net and the box, nothing for
    the pile; the (reordered) distance batch and the chains equal the JAX
    package's, and the node-pair cache exists with collisions on."""
    j, t = _jax(scene), _port(scene)
    assert t.config.distance_chain == j._config.distance_chain
    assert t.config.distance_colors == j._config.distance_colors
    assert t.config.enable_collisions == j._config.enable_collisions
    jt = _np(j._topology)
    np.testing.assert_array_equal(t.topology.distance.idx.numpy(), jt.distance.idx)
    np.testing.assert_array_equal(t.topology.distance.w.numpy(), jt.distance.w)
    if scene == "rope":
        assert t.config.distance_chain
        for f in ("idx0", "anchor", "rest", "w"):
            np.testing.assert_array_equal(getattr(t.topology.chains, f).numpy(),
                                          getattr(jt.chains, f))
    if scene in ("net", "box"):
        assert len(t.config.distance_colors) > 1
    assert (t.state.nn is None) == (j._state.nn is None)
    np.testing.assert_array_equal(t.state.positions.numpy(), np.asarray(j._state.positions))


# ---------------------------------------------------------------------------
# each device function on identical inputs


def _jitter(j, seed, scale=0.05):
    """The JAX solver's positions with seeded offsets (live nodes), as numpy."""
    n = j._builder.num_nodes
    x = np.array(j._state.positions)
    x[:n] += np.random.default_rng(seed).normal(0.0, scale, (n, 3)).astype(np.float32)
    return x


@partial(jax.jit, static_argnames=("kind", "recenter"))
def _jax_family(kind, x, topo, inv_mass, recenter):
    """``_apply_jacobi`` of one family with its JAX projection, as the JAX
    substep applies it (``pies_tpu/solver/pbd.py:80-178``)."""
    if kind == "position":
        p = topo.position
        return jpbd._apply_jacobi(x, p.idx, jproj.project_position(p), p.w)
    if kind == "distance":
        d = topo.distance
        active = jnp.stack([jnp.ones_like(d.w, bool), jnp.zeros_like(d.w, bool)], axis=-1)
        return jpbd._apply_jacobi(x, d.idx, jproj.project_distance(x, d), d.w, active)
    if kind == "strain":
        s = topo.strain
        ps = jproj.project_strain(x, s)
        if recenter:
            ps = ps - jnp.mean(ps, axis=1, keepdims=True) + jnp.mean(x[s.idx], axis=1,
                                                                     keepdims=True)
        return jpbd._apply_jacobi(x, s.idx, ps, s.w)
    b = topo.bend
    return jpbd._apply_jacobi(x, b.idx, jproj.project_bend(x, inv_mass, b), b.w)


@pytest.mark.parametrize("kind,scene", [
    ("position", "rope"), ("distance", "net"), ("strain", "tet_box_quirks"),
    ("strain", "tet_box_fixed"), ("bend", "bend_sheet")])
def test_apply_jacobi_family(kind, scene):
    """One family's rows (T18 stage 1) and count-averaged application (stage
    2) against ``_apply_jacobi`` with the JAX projection, within 1e-6."""
    j = _jax(scene)
    assert not j._config.strain_contiguous
    x = _jitter(j, 7)
    jt = _np(j._topology)
    recenter = not j._config.reference_quirks
    ref = _jax_family(kind, jnp.asarray(x), j._topology, j._state.inv_mass, recenter)
    topo = convert.topology_from_numpy(jt)
    xt = torch.from_numpy(x.copy())
    im = torch.from_numpy(np.array(j._state.inv_mass))
    vals = tproj.jacobi_rows_plain(kind, xt, im, getattr(topo, kind), recenter=recenter)
    tpbd.apply_jacobi_plain(xt, getattr(topo.jacobi, kind), vals)
    moved = float(np.abs(np.asarray(ref) - x).max())
    assert moved > 1e-3  # the family does move the nodes
    assert float(np.abs(xt.numpy() - np.asarray(ref)).max()) <= 1e-6


def _distance_only_substep(j, x):
    """The JAX substep with only the distance form acting: zero gravity and
    velocity, pins released, one iteration, collisions off, nodes far above
    the floor."""
    cfg = dataclasses.replace(j._config, iterations=1, enable_collisions=False)
    params = dataclasses.replace(j.current_params(), gravity=jnp.float32(0.0),
                                 release_hinge=jnp.float32(1.0))
    st = dataclasses.replace(j._state, positions=jnp.asarray(x),
                             velocities=jnp.zeros_like(j._state.velocities))
    out, _ = jpbd.pbd_substep(st, j._topology, params, cfg, jdetect)
    return np.asarray(out.positions)


@pytest.mark.parametrize("scene", ["rope", "net"])
def test_sequential_distance_forms(scene):
    """The chain walk (rope) and the colour classes (net), T19's twins,
    against the JAX substep's distance step, within 1e-6."""
    j = _jax(scene)
    x = _jitter(j, 3)
    ref = _distance_only_substep(j, x)
    topo = convert.topology_from_numpy(_np(j._topology))
    xt = torch.from_numpy(x.copy())
    if scene == "rope":
        assert j._config.distance_chain
        tpbd.chain_scan_plain(xt, topo.chains)
    else:
        tpbd.color_classes_plain(xt, topo.distance, j._config.distance_colors)
    assert float(np.abs(ref - x).max()) > 1e-3
    assert float(np.abs(xt.numpy() - ref).max()) <= 1e-6


@pytest.fixture(scope="module")
def pile12():
    """The JAX pile after 12 ticks, and its node pairs."""
    j = _jax("pile")
    for _ in range(12):
        j.tick()
    st, params, cfg = j._state, j.current_params(), j._config
    cand, ok = _jcand(st, st.positions, params, config=cfg)
    pi, pj, count = _jprefix(st, st.positions, params, config=cfg)
    return j, (cand, ok), (pi, pj, count)


_jcand = jax.jit(jbp._node_pair_candidates, static_argnames=("config",))
_jprefix = jax.jit(jbp._node_pair_prefix, static_argnames=("config",))


def test_node_pair_candidates_and_prefix_equal(pile12):
    """``_node_pair_candidates`` and ``_node_pair_prefix`` (T20's twin) on a
    pile after 12 ticks: the kept pairs per row and the (pi, pj, count)
    prefix exactly equal."""
    j, (cand, ok), (pi, pj, count) = pile12
    ts, _, tcfg, tparams = _carry(j)
    args = (ts.positions, ts.radius, ts.node_mask, tparams, tcfg)
    tc, tok = tb.node_pair_candidates(*args)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(np.where(tok.numpy(), tc.numpy(), 0),
                                  np.where(np.asarray(ok), np.asarray(cand), 0))
    tpi, tpj, tcount = tb.node_pair_prefix(*args)
    c = int(count)
    assert tcount == c > 100
    np.testing.assert_array_equal(tpi[:c].numpy(), np.asarray(pi)[:c])
    np.testing.assert_array_equal(tpj[:c].numpy(), np.asarray(pj)[:c])


def test_pair_response_acc(pile12):
    """``_pair_response_acc`` on the pile's pairs with seeded velocities,
    within 1e-6, touching pairs present."""
    j, _, (pi, pj, count) = pile12
    st, params = j._state, j.current_params()
    rng = np.random.default_rng(5)
    vel = np.asarray(st.velocities) + rng.normal(0, 1.0, st.velocities.shape).astype(np.float32)
    ref = jax.jit(jbp._pair_response_acc)(st, st.positions, jnp.asarray(vel), pi, pj, count,
                                          params)
    ts, _, _, tparams = _carry(j)
    c = int(count)
    pi_t, pj_t = torch.from_numpy(np.array(pi)), torch.from_numpy(np.array(pj))
    vel_t = torch.from_numpy(vel)
    acc = tb.pair_response_acc(ts.positions, vel_t, ts.radius, ts.inv_mass, pi_t, pj_t, c,
                               tparams)
    _, _, touching = tb.pair_terms(ts.positions, vel_t, ts.radius, ts.inv_mass, pi_t[:c],
                                   pj_t[:c], tparams)
    assert int(touching.sum()) > 0
    assert float(np.abs(acc.numpy() - np.asarray(ref)).max()) <= 1e-6


# ---------------------------------------------------------------------------
# one tick and 40 ticks


# Ticks before the one compared.  The quirk-mode tet box is blended toward
# the origin and flattens on the floor at tick 2 (the smallest singular
# value of F is then exactly 0, and U's third column comes from roundoff):
# from there the JAX package's own tick, started one ulp away, parts by up
# to 0.09, so its step is compared at tick 1.
WARM = {"tet_box_quirks": 1}


@pytest.mark.parametrize("scene", list(SCENES))
def test_one_tick_from_the_jax_state(scene):
    """From the JAX state after 5 ticks (``WARM``), one port tick lands
    within 3e-6 of the JAX tick; the latch and the pair cache's count and
    freshness equal."""
    j = _jax(scene)
    for _ in range(WARM.get(scene, 5)):
        j.tick()
    ts, topo, cfg, params = _carry(j)
    tstep.tick(ts, topo, params, cfg)
    ref, _ = jtick(j._state, j._topology, j.current_params(), j._config)
    err = float(np.abs(ts.positions.numpy() - np.asarray(ref.positions)).max())
    assert err <= STEP_TOL, err
    assert ts.failed() == bool(ref.sim_failed) == False  # noqa: E712
    if ref.nn is not None:
        assert int(ts.nn.count[0]) == int(ref.nn.count) > 0
        assert int(ts.nn.fresh[0]) == int(ref.nn.fresh)


# Position bounds of the 40-tick runs, from the JAX package's own float32
# spread (jax_spread: 12 runs started one to four ulps away).  Rope: spread
# 1.7e-5 to 5.4e-3 (median 1.1e-3), the port 2.5e-4.  Pile: spread 0.047 to
# 6.8 (once two runs part, the per-cell cap and the candidate budget drop
# different pairs), the port 6.2e-3.  Net: spread 7.0e-7 to 3.8e-6, the
# port 0.
RUN_TOL = {"rope": 1e-3, "pile": 0.05, "net": 4e-6}


def _perturbed(j, seed, frac, ulps=1):
    """Move a random ``frac`` of the JAX solver's initial coordinates
    ``ulps`` float32 ulps up or down."""
    rng = np.random.default_rng(seed)
    n = j._builder.num_nodes
    p = np.array(j._state.positions)
    sel = rng.random(p[:n].shape) < frac
    d = np.where(rng.random(p[:n].shape) < 0.5, np.float32(np.inf), np.float32(-np.inf))
    q = p[:n]
    for _ in range(ulps):
        q = np.nextafter(q, d)
    p[:n] = np.where(sel, q, p[:n])
    j._state = dataclasses.replace(j._state, positions=jnp.asarray(p),
                                   prev_positions=jnp.asarray(p))


def _jax_run(scene, ticks, perturb=None):
    """``ticks`` JAX ticks: positions after each, and per tick whether the
    pair cache was rebuilt (its reference moved) and the latch."""
    j = _jax(scene)
    if perturb is not None:
        _perturbed(j, *perturb)
    n = j._builder.num_nodes
    pos, rebuilt, failed = [], [], []
    for _ in range(ticks):
        ref = None if j._state.nn is None else np.asarray(j._state.nn.ref)
        j.tick()
        pos.append(np.asarray(j._state.positions)[:n])
        rebuilt.append(ref is not None and not np.array_equal(ref, np.asarray(j._state.nn.ref)))
        failed.append(bool(j._state.sim_failed))
    return np.stack(pos), rebuilt, failed


def jax_spread(scene, ticks=40, seeds=4):
    """The JAX package's own spread on a scene: the largest distance over
    ``ticks`` between the unperturbed run and runs whose initial
    coordinates moved by ulps (``seeds`` seeds, each with a tenth, nine
    tenths and half of the coordinates, the last by 4 ulps)."""
    ref = _jax_run(scene, ticks)[0]
    return [float(np.abs(_jax_run(scene, ticks, (seed, frac, ulps))[0] - ref).max())
            for seed in range(seeds) for frac, ulps in ((0.1, 1), (0.9, 1), (0.5, 4))]


@pytest.mark.parametrize("scene", list(RUN_TOL))
def test_forty_ticks_match_reference(scene):
    """40 ticks through both packages' ``Solver``: positions within
    ``RUN_TOL``, the pair cache rebuilt on the same ticks, the latch on the
    same ticks (never)."""
    ticks = 40
    ref, ref_rebuilt, ref_failed = _jax_run(scene, ticks)
    t = _port(scene)
    n = t._builder.num_nodes
    pos, rebuilt, failed, touching = [], [], [], 0
    for _ in range(ticks):
        t.counters = tpbd.new_counters("cpu")
        t.tick()
        pos.append(t.state.positions[:n].numpy().copy())
        rebuilt.append(int(t.counters["rebuilds"]) > 0)
        failed.append(t.sim_failed)
        touching += int(t.counters["touching"])
    assert failed == ref_failed == [False] * ticks
    assert rebuilt == ref_rebuilt
    if t.state.nn is not None:
        assert any(rebuilt) and touching > 0
    err = float(np.abs(np.stack(pos) - ref).max())
    assert err <= RUN_TOL[scene], err


def test_release_hinge_mid_run():
    """``release_hinge`` set after 10 ticks drops the ropes' pins in both
    packages alike: 20 ticks within the rope's bound, and the pinned ends
    held, then falling."""
    j, t = _jax("rope"), _port("rope")
    n = t._builder.num_nodes
    for k in range(20):
        if k == 10:
            j.release_hinge = t.release_hinge = True
        j.tick()
        t.tick()
        if k == 9:
            held = t.state.positions[0, 1].item()
            assert held == pytest.approx(8.0, abs=1e-6)
    assert t.current_params().release_hinge == 1.0
    assert t.state.positions[0, 1].item() < held - 0.05
    err = float(np.abs(t.state.positions[:n].numpy() - np.asarray(j._state.positions)[:n]).max())
    assert err <= RUN_TOL["rope"], err


# ---------------------------------------------------------------------------
# the node-pair cache (tests/test_collisions.py:654-720 on the port)


def _small_pile(n=12, seed=0, **opts):
    rng = np.random.default_rng(seed)
    pos = rng.uniform([-1.5, 1.0, -1.5], [1.5, 3.0, 1.5], (n, 3)).astype(np.float32)
    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PBD, iterations=4, **opts),
                  enable_collisions=True, device="cpu")
    s.add_nodes(pos)
    s._prepare()
    assert s.state.nn is not None
    return s


def test_cached_ticks_match_uncached():
    sa, sb = _small_pile(), _small_pile()
    sb.state.nn = None  # rebuild on every iteration
    for _ in range(6):
        sa.tick()
        sb.tick()
        np.testing.assert_allclose(sa.get_vertices()["position"], sb.get_vertices()["position"],
                                   atol=5e-4)
    assert not sa.sim_failed and not sb.sim_failed


def test_rebuild_on_drift_catches_new_contacts():
    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PBD, iterations=4, gravity=0.0),
                  enable_collisions=True, device="cpu")
    s.add_nodes(np.array([[-6, 5, 0], [6, 5, 0]], np.float32))
    s.state.velocities[0] = torch.tensor([8.0, 0.0, 0.0])
    s.state.velocities[1] = torch.tensor([-8.0, 0.0, 0.0])
    for _ in range(80):
        s.tick()
    p = s.get_vertices()["position"]
    assert abs(float(p[1, 0] - p[0, 0])) > 0.7
    assert not s.sim_failed


def test_cache_reuses_at_rest():
    s = _small_pile()
    for _ in range(150):
        s.tick()
    ref = s.state.nn.ref.clone()
    s.counters = tpbd.new_counters("cpu")
    s.tick()
    assert int(s.counters["rebuilds"]) == 0 and int(s.state.nn.fresh[0]) == 1
    assert torch.equal(s.state.nn.ref, ref), "settled pile rebuilt its cache"
    assert not s.sim_failed


# ---------------------------------------------------------------------------
# checkpoints across the packages


def test_checkpoint_from_jax_to_port_and_back(tmp_path):
    """A pile saved by the JAX package after 8 ticks loads into the port
    (``Solver.load``): its next tick lands within 3e-6 of the JAX one.  The
    port's checkpoint of that state loads back into the JAX package, whose
    next tick lands within 3e-6 of the port's."""
    j, t = _jax("pile"), _port("pile")
    for _ in range(8):
        j.tick()
    j.save(str(tmp_path / "jax.npz"))
    t.load(str(tmp_path / "jax.npz"))
    assert int(t.state.nn.fresh[0]) == 1 and int(t.state.nn.count[0]) > 0
    j.tick()
    t.tick()
    n = t._builder.num_nodes
    jp = lambda: np.asarray(j._state.positions)[:n]
    assert float(np.abs(t.state.positions[:n].numpy() - jp()).max()) <= STEP_TOL
    t.save(str(tmp_path / "port.npz"))
    j.load(str(tmp_path / "port.npz"))
    j.tick()
    t.tick()
    assert float(np.abs(t.state.positions[:n].numpy() - jp()).max()) <= STEP_TOL
    assert not j.sim_failed and not t.sim_failed
