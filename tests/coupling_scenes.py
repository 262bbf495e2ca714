"""The scenes, JAX runs and checks shared by ``tests/test_torch_coupling.py``
and ``tests/test_torch_coupling_scenes.py``: full contact coupling, the
disjoint-tet block preconditioner and the entry-list floor of the port (the
plain twins of kernels T22, T23 and T24) against the JAX package.

Scenes (inputs from the builders' seeds, the same code in both packages;
the JAX solvers with ``dense_operator_max=0``, since the port does not
prefactor small scenes):

* ``soup_full``: 24 tets at spacing 1.0 (floor contact from tick 24,
  point-triangle contacts from tick 31) with ``contact_coupling="full"``:
  the generic path with the block preconditioner, T23 in the operator and
  the force;
* ``soup_block``: the same soup with ``tet_cols=False`` (recentered
  coupling): the exact block preconditioner, one CG trip per solve;
* ``box_entry``: ``create_tet_box`` at y = 0.5 (``tests/test_collisions.py:
  555``, lowered so that it lands at tick 26) with ``dense_floor=False``:
  the entry-list floor, collisions off;
* ``mixed_full``: 40 tets under an 8 x 8 sheet at y = 2.2 with
  ``allpairs_broadphase_max=0`` (``tests/test_torch_super.py``'s scene, in
  contact from the first tick) and full coupling: T23 beside the ELL and the
  band, under Jacobi.

Each scene's JAX run (its compile is most of a test file's time) is made
once per process, and its state after ``WARM`` ticks is the snapshot the
finer checks read.
"""

import dataclasses
from functools import partial

import jax
import numpy as np
import torch

import pies_tpu
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.solver import assembly as jasm
from pies_tpu.solver.step import default_detect_collisions as jdetect_all
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.collision.batches import CollisionSet, incidence_plain
from pies_tpu_torch.scene.mixed_drape import add_mixed_drape
from pies_tpu_torch.solver import assembly as tasm
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import step as tstep

STEP_TOL = 3e-6
TICKS = 40


def _soup(s):
    s.create_tet_soup(24, spacing=1.0, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
    return s


def _box(s):
    s.create_tet_box((0.0, 0.5, 0.0), 1.0, (0, 0, 0), w=1500.0, mass=1.0)
    return s


def _mixed(s):
    add_mixed_drape(s, 40, 8, sheet_y=2.2)
    return s


# scene -> (builder, Solver arguments, StepConfig fields set after _prepare)
SCENES = {
    "soup_full": (_soup, dict(enable_collisions=True, contact_coupling="full"), {}),
    "soup_block": (_soup, dict(enable_collisions=True), dict(tet_cols=False)),
    "box_entry": (_box, dict(enable_collisions=False), dict(dense_floor=False)),
    "mixed_full": (_mixed, dict(enable_collisions=True, contact_coupling="full",
                                allpairs_broadphase_max=0), {}),
}
# Ticks before the one compared and the snapshot the finer checks read: the
# soups with live contacts, the box on the floor.
# (Tick 34 of soup_full is a knife edge, where a contact's discrete test
# flips: the JAX package's own tick from that state moved by one ulp parts
# from it by far more than 3e-6.)
WARM = {"soup_full": 36, "soup_block": 34, "box_entry": 30, "mixed_full": 5}
# 40-tick bounds from the JAX package's own spread (jax_spread below, 12
# runs started one to four ulps away; measured min / median / max, then the
# port): soup_full 2.46e-3 / 2.47e-3 / 2.48e-3 (every run parts at the
# first point-triangle contact, tick 31), the port 2.46e-3; soup_block
# 5.0e-5 / 7.1e-5 / 3.7e-3, the port 1.0e-4; box_entry 4.1e-6 / 8.4e-6 /
# 1.6e-5, the port 6.9e-6; mixed_full 6.8e-5 / 1.1e-4 / 2.9e-3, the port
# 1.3e-4.  Before any contact the port drifts from the JAX package by about
# one float32 ulp of the positions per tick.
RUN_TOL = {"soup_full": 5e-3, "soup_block": 1e-3, "box_entry": 5e-5, "mixed_full": 1e-3}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_solver(scene):
    build, kw, cfg = SCENES[scene]
    j = build(pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0, **kw))
    j._prepare()
    j._config = dataclasses.replace(j._config, **cfg)
    return j


def port_solver(scene, **cfg_over):
    build, kw, cfg = SCENES[scene]
    t = build(pt.Solver(pt.SolverOptions(), device="cpu", **kw))
    t._prepare()
    t._config = dataclasses.replace(t._config, **{**cfg, **cfg_over})
    return t


_RUNS = {}


def jax_run(scene):
    """The JAX solver's 40 ticks (positions and latch per tick, live nodes)
    and its state, topology, params and config after ``WARM`` ticks."""
    if scene not in _RUNS:
        j = jax_solver(scene)
        n = j._builder.num_nodes
        pos, failed, snap = [], [], None
        for k in range(TICKS):
            if k == WARM[scene]:
                snap = (j._state, j._topology, j.current_params(), j._config)
            j.tick()
            pos.append(np.asarray(j._state.positions)[:n])
            failed.append(bool(j._state.sim_failed))
        _RUNS[scene] = (np.stack(pos), failed, snap, n)
    return _RUNS[scene]


def _perturbed(j, seed, frac, ulps):
    """Move a random ``frac`` of the JAX solver's live initial coordinates
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
    j._state = dataclasses.replace(j._state, positions=jax.numpy.asarray(p),
                                   prev_positions=jax.numpy.asarray(p))


def jax_spread(scene, seeds=4):
    """The JAX package's own float32 spread on a scene (as
    ``tests/test_torch_pbd.py``'s): the largest distance over 40 ticks
    between its run and runs whose initial coordinates moved by ulps
    (``seeds`` seeds, each with a tenth, nine tenths and half of the
    coordinates, the last by 4 ulps).  Not run by the tests: it sets
    ``RUN_TOL``."""
    ref = jax_run(scene)[0]
    out = []
    for seed in range(seeds):
        for frac, ulps in ((0.1, 1), (0.9, 1), (0.5, 4)):
            j = jax_solver(scene)
            _perturbed(j, seed, frac, ulps)
            pos = []
            for _ in range(TICKS):
                j.tick()
                pos.append(np.asarray(j._state.positions)[: j._builder.num_nodes])
            out.append(float(np.abs(np.stack(pos) - ref).max()))
    return out


def carry(snap):
    """The port's state, topology, params and config from a JAX snapshot."""
    st, topo, params, cfg = snap
    return (convert.state_from_numpy(np_tree(st)),
            convert.topology_from_numpy(np_tree(topo), tet_fused=cfg.tet_fused),
            convert.params_from(np_tree(params)), convert.config_from(cfg))


_jdetect = jax.jit(jdetect_all, static_argnames=("config",))
_SYSTEMS = {}


def system(scene, detect_config=None):
    """The JAX substep's system on the scene's snapshot (``pd.py:59-147``):
    the predicted positions, the collision set (detected under
    ``detect_config``, by default the scene's: the detection reads no
    coupling field, so scenes can share its compile), the diagonals and the
    operator; and the port's inputs for the same."""
    if scene in _SYSTEMS:
        return _SYSTEMS[scene]
    _, _, snap, _ = jax_run(scene)
    st, topo, params, cfg = snap
    h = params.dt
    h2 = h * h
    x = st.positions + h * st.velocities * st.node_mask[:, None]
    colls = _jdetect(st, x, topo, params, config=detect_config or cfg)
    moh2 = st.mass / h2
    diag = jasm.system_diag(moh2, topo, colls)
    static_diag = jasm.static_collision_diag(colls, st.capacity, x.dtype, topo.floor_count)
    if cfg.contact_coupling != "full":
        static_diag = static_diag + jasm.point_tri_collision_diag(colls, st.capacity, x.dtype)
    matvec = partial(jasm.apply_system, mass_over_h2=moh2, topo=topo, colls=colls,
                     strain_contiguous=cfg.strain_contiguous,
                     volume_contiguous=cfg.volume_contiguous, static_diag=static_diag,
                     contact_coupling=cfg.contact_coupling, tet_shared=cfg.tet_fused)
    tst, ttopo, tparams, _ = carry(snap)
    live = int(np.asarray(colls.pt_mask).sum())
    idx = torch.from_numpy(np.array(colls.pt_idx))
    tcolls = CollisionSet(floor_active=torch.from_numpy(np.array(colls.floor_active)),
                          pt_idx=idx, pt_mask=torch.from_numpy(np.array(colls.pt_mask)),
                          pt_count=torch.tensor([live], dtype=torch.int32))
    full = tasm.FullCoupling(tcolls, incidence_plain(idx, tcolls.pt_count, tst.capacity),
                             tparams.collision_thickness)
    _SYSTEMS[scene] = dict(x=x, colls=colls, diag=diag, static_diag=static_diag,
                           matvec=matvec, topo=topo, live=live, tst=tst, ttopo=ttopo,
                           tparams=tparams, full=full, h2=float(np.float32(h2)))
    return _SYSTEMS[scene]


def operator_matches(sy):
    """``apply_system_plain`` with full coupling (T23 in T10) against the
    JAX ``apply_system(contact_coupling="full")`` on the system ``sy``, at
    the predicted positions and at seeded ones: within 1e-6 of the largest
    entry, and far from the product without the contact blocks."""
    assert sy["live"] > 0
    rng = np.random.default_rng(11)
    wf = torch.from_numpy(np.array(sy["static_diag"]))
    x = np.asarray(sy["x"])
    for v in (x, rng.normal(size=x.shape).astype(np.float32)):
        ref = np.asarray(sy["matvec"](jax.numpy.asarray(v)))
        y, _ = tasm.apply_system_plain(torch.from_numpy(v.copy()), sy["tst"].mass, wf, sy["h2"],
                                       sy["ttopo"], full=sy["full"])
        assert np.abs(y.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    bare, _ = tasm.apply_system_plain(torch.from_numpy(v.copy()), sy["tst"].mass, wf, sy["h2"],
                                      sy["ttopo"])
    assert np.abs(bare.numpy() - ref).max() > 1e-3 * np.abs(ref).max()


def contact_set(idx, mask):
    idx, mask = np.asarray(idx), np.asarray(mask)
    return {tuple(r) for r in idx[mask > 0].tolist()}


def one_tick_matches(scene, detect_config=None):
    """From the JAX state after ``WARM`` ticks, one port tick lands within
    3e-6 of the JAX tick, with no latch and floor contact (but on the mixed
    scene, whose soup lands later); that state's contacts (with
    self-contact) are live and equal the JAX detection's as sets, its floor
    entries (the box) are live."""
    ref, _, snap, n = jax_run(scene)
    ts, topo, params, cfg = carry(snap)
    x = ts.positions + params.dt * ts.velocities * ts.node_mask[:, None]
    if cfg.enable_collisions:
        sy = system(scene, detect_config)
        tcolls = tpd.detect_point_tri(carry(snap)[0], x, topo, params, cfg,
                                      torch.zeros(ts.capacity))
        got = contact_set(tcolls.pt_idx, tcolls.pt_mask)
        assert got == contact_set(sy["colls"].pt_idx, sy["colls"].pt_mask) and got
    else:
        assert float(tpd.default_detect_collisions(x, topo, params, cfg).floor_counts.sum()) > 0
    counters = tpd.new_counters("cpu")
    tstep.tick(ts, topo, params, cfg, counters=counters)
    err = float(np.abs(ts.positions[:n].numpy() - ref[WARM[scene]]).max())
    assert err <= STEP_TOL, err
    assert ts.failed() is False
    assert int(counters["floor_active"]) > 0 or scene == "mixed_full"


def forty_ticks_match(scene):
    """40 ticks through both packages' ``Solver``: positions within
    ``RUN_TOL``, the latch on the same ticks (never); floor contact, and
    with self-contact live contacts, in the port's run."""
    ref, ref_failed, _, n = jax_run(scene)
    t = port_solver(scene)
    pos, failed = [], []
    t.counters = tpd.new_counters("cpu")
    for _ in range(TICKS):
        t.tick()
        pos.append(t.state.positions[:n].numpy().copy())
        failed.append(t.sim_failed)
    assert failed == ref_failed == [False] * TICKS
    assert int(t.counters["floor_active"]) > 0
    if t.config.enable_collisions:
        assert int(t.counters["contacts"]) > 0
    err = float(np.abs(np.stack(pos) - ref).max())
    assert err <= RUN_TOL[scene], err
