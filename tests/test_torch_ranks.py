"""The port's domain decomposition and ensembles across ``torch.distributed``
ranks (``pies_tpu_torch.parallel.ranks``, ROADMAP item 11b) against the JAX
package's ``shard_map`` forms on the 8 virtual CPU devices of
``tests/conftest.py``.

One module-scoped fixture starts R = 2 gloo ranks once (``ranks.launch``:
start method ``spawn``, a ``FileStore`` under ``tmp_path_factory``, one
torch thread a rank) and hands them every case; the ranks run
``tests/rank_cases.py``, which imports no JAX, and each rank reports its
``sys.modules``.  While they run, the parent runs the JAX side and the
port's one-process references.

* The ensemble: ``tests/test_parallel.py``'s rope at 8 and 16 members,
  each member's live nodes moved by its own seeded offset (uniform ±0.02),
  one member latched before the start, 5 steps.  The ranks' members,
  gathered, equal the port's one-process ``ensemble_step`` bit for bit,
  ``max_residual`` and ``num_failed`` too; against JAX ``make_sharded_step``
  the positions within 1e-5 (``test_parallel.py``'s tolerance), the latched
  count equal and the largest residual within 1e-3 of the JAX one or 1e-6
  (the rope's CG ends at float32 roundoff, ~1e-17 against forces of
  ~1e5, where the two packages' last bits differ).
* The domain: ``domain_cases.SCENES``' ``tet_boxes`` (4 slabs over the 2
  ranks: inner and cross-rank halos), ``pile`` (2 over 2: contacts,
  stabilization, friction), ``node_line`` and ``edge_strips`` (2 over 2).
  Against JAX ``make_domain_tick`` under ``domain_cases``' bounds: one
  tick and ten, the latch on the same tick, on ``tet_boxes`` and ``pile``;
  one JAX tick on ``node_line`` and ``edge_strips``, whose ten ticks
  ``tests/test_torch_domain_edges.py`` holds to the JAX domain through the
  port's one-device domain, which their ranks equal bit for bit on all ten
  ticks here.  Against the port's one-device domain tick: one tick within
  1e-5, the latch on the same tick.  A rerun
  from the same partition is bit-identical on every rank.  T30's outer-band
  modes (refresh and reduce with the exchanged bands; the reduce's sum,
  average, apply and p·Ap partials) equal the one-device stages over all
  the slabs bit for bit, at each scene's shapes and with 2B > L.
* The latch: a NaN in one node of rank 1's first slab latches both ranks
  on that tick, as it latches the one-device domain.
"""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pies_tpu.options import SolverName as JName, SolverOptions as JOptions, StepConfig as JConfig
from pies_tpu.options import make_params as jmake_params
from pies_tpu.parallel import domain as jdomain, ensemble as jens
from pies_tpu.solver import step as jstep
from pies_tpu_torch import convert
from pies_tpu_torch.parallel import domain, ensemble, ranks

import rank_cases
from domain_cases import JAX_TICKS, OPT0, SCENES, STEP_TOL, bounds, jax_scene, numpy_scene
from test_parallel import rope_scene
from torch_threads import two_threads  # noqa: F401

RANKS = 2
MEMBERS = (8, 16)
ENS_TICKS = 5
DOMAINS = ("tet_boxes", "pile", "node_line", "edge_strips")
# The scenes whose ranks equal the one-device domain bit for bit on every
# tick: one JAX tick each here (test_torch_domain_edges.py holds the
# one-device domain's ten ticks to the JAX domain)
ONE_JAX_TICK = ("node_line", "edge_strips")
WIDE = domain.DomainMeta(n_slabs=4, block=16, halo=12)  # 2B > L


def _fake_mesh(rank, world=RANKS):
    """A mesh with no process group: the sharding helpers read only the
    rank, the world size and the device."""
    return ranks.Mesh(rank=rank, world=world, group=None, device=torch.device("cpu"),
                      backend="gloo")


def _rope_ensemble(b):
    """The JAX rope ensemble of ``b`` members (NumPy leaves), member b - 3
    latched, every member's live nodes moved by its own seeded offset."""
    state, topo = rope_scene()
    states = jax.tree.map(np.array, jens.stack_ensemble(state, b))
    n = states.positions.shape[1]
    for m in range(b):
        off = np.random.default_rng(m).uniform(-0.02, 0.02, (n, 3)).astype(np.float32)
        states.positions[m] += off
        states.prev_positions[m] += off
    states.sim_failed[b - 3] = True
    return states, topo


def _jax_ensemble(b):
    """JAX ``make_sharded_step`` on the 8 virtual devices: per step
    ``(max_residual, num_failed)`` and the final positions."""
    states, topo = _rope_ensemble(b)
    mesh = jens.make_mesh()
    cfg = JConfig(solver=JName.PD, enable_collisions=False)
    params = jmake_params(JOptions())
    step = jens.make_sharded_step(mesh, cfg)
    js = jens.shard_ensemble(jax.tree.map(jnp.asarray, states), mesh)
    diag = []
    for _ in range(ENS_TICKS):
        js, res, failed = step(js, topo, params)
        diag.append((float(res), int(failed)))
    return dict(diag=diag, positions=np.asarray(js.positions))


def _ensemble_case(b):
    states, topo = _rope_ensemble(b)
    cfg = JConfig(solver=JName.PD, enable_collisions=False)
    return dict(kind="ensemble", states=convert.ensemble_from_numpy(states),
                topo=convert.topology_from_numpy(jax.tree.map(np.asarray, topo)),
                params=convert.params_from(jax.tree.map(np.asarray, jmake_params(JOptions()))),
                config=convert.config_from(cfg), ticks=ENS_TICKS)


def _domain_scene(name):
    """The JAX scene and its partition: ``(solver, jdom, params, cfg,
    n_live)``; the configuration with ``unroll_loops=False`` (the JAX
    package's ``fori_loop`` form: a third of the compile time, and on these
    scenes the same positions bit for bit as the unrolled ticks)."""
    _, n_slabs, _, _, _, _, margin = SCENES[name]
    s = jax_scene(name)
    state0, topo0, params, cfg, n_live = numpy_scene(s)
    cfg = dataclasses.replace(cfg, unroll_loops=False)
    jdom = jdomain.partition_domain(state0, topo0, n_slabs=n_slabs, collision_margin=margin)
    return s, jdom, params, cfg, n_live


def _jax_domain(s, jdom, params, cfg, n_live, port_dom, ticks=JAX_TICKS):
    """``ticks`` JAX domain ticks (compiled once, at ``OPT0``) and, where the
    port's one-device domain parts from them by more than 3e-6, the JAX
    package's own single-device ticks (``domain_cases.run_case``)."""
    n_slabs = jdom.meta.n_slabs
    mesh = jens.make_mesh(n_slabs, axis="x")
    sh = NamedSharding(mesh, P("x"))
    put = lambda a: jax.device_put(jnp.asarray(a), sh)  # noqa: E731
    dstate, dstatic = jax.tree.map(put, jdom.state), jax.tree.map(put, jdom.static)
    dtick = jdomain.make_domain_tick(mesh, cfg, jdom.meta).lower(
        dstate, dstatic, params).compile(compiler_options=OPT0)
    traj, failed = [], []
    for _ in range(ticks):
        dstate, _ = dtick(dstate, dstatic, params)
        traj.append(jdomain.gather_positions(jdom, dstate)[:n_live])
        failed.append(bool(np.any(np.asarray(dstate.sim_failed))))
    traj = np.stack(traj)
    single = None
    apart = np.abs(port_dom[:ticks] - traj).reshape(ticks, -1).max(1)
    if apart[0] > STEP_TOL or apart[-1] > STEP_TOL:
        stick = jax.jit(jstep.tick, static_argnames=("config",), compiler_options=OPT0)
        st, single = s._state, []
        for _ in range(ticks):
            st, _ = stick(st, s._topology, params, config=cfg)
            single.append(np.asarray(st.positions)[:n_live])
        single = np.stack(single)
    return dict(jax_dom=traj, jax_failed=failed, jax_single=single)


def _port_one_device(jdom, pparams, pcfg, n_live):
    """The port's domain on one device (all slabs): ``JAX_TICKS`` ticks."""
    pdom = convert.domain_from_numpy(jdom, "cpu")
    tick = domain.make_domain_tick(pcfg, pdom.meta, device="cpu")
    traj, failed = [], []
    for _ in range(JAX_TICKS):
        tick(pdom.state, pdom.static, pparams)
        traj.append(domain.gather_positions(pdom, pdom.state)[:n_live])
        failed.append(bool(pdom.state.sim_failed.any()))
    return np.stack(traj), failed


def _nan_node(host, meta):
    """A live node of rank 1's first slab (slab D/R), local index."""
    first = meta.n_slabs // RANKS
    mask = host["static.node_mask_view"][first, meta.halo:meta.halo + meta.block]
    return int(np.nonzero(mask > 0)[0][0])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results (``[rank 0's, rank 1's]``) and the parent's JAX
    and one-device references, computed while the ranks run."""
    scenes = {name: _domain_scene(name) for name in DOMAINS}
    cases = {f"ensemble {b}": _ensemble_case(b) for b in MEMBERS}
    conv = {}
    for name, (s, jdom, params, cfg, n_live) in scenes.items():
        host, meta = convert.domain_host(jdom)
        pparams = convert.params_from(jax.tree.map(np.asarray, params))
        pcfg = convert.config_from(cfg)
        conv[name] = (pparams, pcfg)
        cases[name] = dict(kind="domain", host=host, meta=meta, params=pparams, config=pcfg,
                           n_live=n_live, ticks=JAX_TICKS, rerun=2, seed=len(name),
                           wide=WIDE if name == "tet_boxes" else None)
    host, meta = convert.domain_host(scenes["tet_boxes"][1])
    cases["latch"] = dict(kind="latch", host=host, meta=meta, params=conv["tet_boxes"][0],
                          config=conv["tet_boxes"][1], nan_rank=1, node=_nan_node(host, meta))
    store = str(tmp_path_factory.mktemp("ranks"))
    path = os.path.join(store, "cases.pt")
    torch.save(cases, path)
    got = {}

    def run():
        try:
            got["ranks"] = ranks.launch(rank_cases.worker, RANKS, "gloo", path,
                                        store_dir=store)
        except BaseException as e:  # (re-raised in the test process below)
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    refs = {f"ensemble {b}": _jax_ensemble(b) for b in MEMBERS}
    for name, (s, jdom, params, cfg, n_live) in scenes.items():
        pparams, pcfg = conv[name]
        port_dom, port_failed = _port_one_device(jdom, pparams, pcfg, n_live)
        ticks = 1 if name in ONE_JAX_TICK else JAX_TICKS
        refs[name] = dict(_jax_domain(s, jdom, params, cfg, n_live, port_dom, ticks),
                          port_dom=port_dom, port_failed=port_failed)
    # The one-device domain with the same NaN: it latches on the same tick.
    jdom, (pparams, pcfg) = scenes["tet_boxes"][1], conv["tet_boxes"]
    pdom = convert.domain_from_numpy(jdom, "cpu")
    pdom.state.positions[meta.n_slabs // RANKS, cases["latch"]["node"], 0] = float("nan")
    domain.make_domain_tick(pcfg, pdom.meta)(pdom.state, pdom.static, pparams)
    refs["latch"] = bool(pdom.state.sim_failed.any())
    thread.join()
    if "error" in got:
        raise got["error"]
    return got["ranks"], refs


def test_ranks_import_no_jax(world):
    results, _ = world
    assert [r["rank"] for r in results] == list(range(RANKS))
    for r in results:
        assert r["imports"] == [], r["imports"]


@pytest.mark.parametrize("b", MEMBERS)
def test_sharded_ensemble_equals_one_process(world, b):
    results, _ = world
    for r in results:
        got = r[f"ensemble {b}"]
        assert got["equal"]
        assert got["diag"] == got["one"]
        assert got["diag"][-1][1] == 1


@pytest.mark.parametrize("b", MEMBERS)
def test_sharded_ensemble_matches_jax(world, b):
    results, refs = world
    ref = refs[f"ensemble {b}"]
    got = results[0][f"ensemble {b}"]
    assert np.abs(got["positions"] - ref["positions"]).max() <= 1e-5
    for (res, failed), (jres, jfailed) in zip(got["diag"], ref["diag"]):
        assert failed == jfailed
        assert abs(res - jres) <= max(1e-3 * abs(jres), 1e-6), (res, jres)


def test_shard_ensemble_takes_contiguous_members():
    states, _ = _rope_ensemble(8)
    full = convert.ensemble_from_numpy(states)
    for r in range(RANKS):
        part = ensemble.shard_ensemble(full, _fake_mesh(r))
        carried = convert.ensemble_from_numpy(states, mesh=_fake_mesh(r))
        assert torch.equal(part.positions, full.positions[4 * r:4 * r + 4])
        assert torch.equal(carried.positions, part.positions)
        assert torch.equal(carried.sim_failed, part.sim_failed)
    with pytest.raises(ValueError):
        ensemble.shard_ensemble(full, _fake_mesh(0, world=3))


@pytest.mark.parametrize("name", DOMAINS)
def test_domain_matches_jax(world, name):
    results, refs = world
    ref = refs[name]
    case = dict(ref, name=name)
    one, ten, spread = bounds(case)
    ticks = len(ref["jax_dom"])
    for r in results:
        got = r[name]
        d = np.abs(got["traj"][:ticks] - ref["jax_dom"]).reshape(ticks, -1).max(1)
        assert d[0] <= one, (d[0], one, spread[0])
        assert d[-1] <= ten, (d[-1], ten, spread[-1])
        assert got["latch"][:ticks] == ref["jax_failed"]
        assert np.isfinite(got["traj"]).all()
        if name in ONE_JAX_TICK:  # (the other nine ticks: through the one-device domain)
            assert np.array_equal(got["traj"], ref["port_dom"])
            assert got["latch"] == ref["port_failed"]


@pytest.mark.parametrize("name", DOMAINS)
def test_domain_matches_one_device(world, name):
    results, refs = world
    ref = refs[name]
    for r in results:
        got = r[name]
        assert np.abs(got["traj"][0] - ref["port_dom"][0]).max() <= 1e-5
        assert got["latch"] == ref["port_failed"]
        d, l = SCENES[name][1] // RANKS, got["local"][1]
        assert got["local"] == (d, l, 3)


@pytest.mark.parametrize("name", DOMAINS)
def test_domain_rerun_bit_identical(world, name):
    results, _ = world
    assert all(r[name]["rerun"] for r in results)


@pytest.mark.parametrize("name", DOMAINS)
def test_outer_band_twins_equal_one_device(world, name):
    results, _ = world
    for r in results:
        bands = r[name]["bands"]
        assert bands and all(bands.values()), {k: v for k, v in bands.items() if not v}
        if name == "tet_boxes":
            assert any("2B > L" in k for k in bands)


def test_nan_latches_every_rank(world):
    results, refs = world
    assert refs["latch"]
    for r in results:
        assert not r["latch"]["before"] and r["latch"]["after"]


def test_shard_domain_keeps_each_ranks_slabs():
    """``convert.domain_from_numpy`` with a mesh and ``shard_domain`` give
    each rank its contiguous slabs of the whole partition; a world size
    that does not divide the slab count raises."""
    _, jdom, _, _, _ = _domain_scene("tet_boxes")
    whole = convert.domain_from_numpy(jdom, "cpu")
    for r in range(RANKS):
        part = domain.shard_domain(whole, _fake_mesh(r))
        carried = convert.domain_from_numpy(jdom, mesh=_fake_mesh(r))
        assert part.meta == whole.meta
        assert torch.equal(part.state.positions, whole.state.positions[2 * r:2 * r + 2])
        assert torch.equal(carried.static.mass_view, whole.static.mass_view[2 * r:2 * r + 2])
        assert part.static.topo.stiffness_diag.shape[0] == 2 * whole.meta.view
    with pytest.raises(ValueError):
        domain.shard_domain(whole, _fake_mesh(0, world=3))
    with pytest.raises(ValueError):
        domain.make_domain_tick(convert.config_from(jax_scene("tet_boxes")._config), whole.meta,
                                mesh=_fake_mesh(0, world=3))
