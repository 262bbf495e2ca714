"""The port's per-triangle point-triangle detection (the plain twins of
kernels T16 and T17: all-pairs, cell-list, per-body and reference
broadphases, and the shared CCD tail) against the JAX package, on the CPU.

Detection runs on identical float32 inputs, made from a numpy seed, through
``pies_tpu.collision.broadphase.detect_point_tri_collisions`` (jitted, one
compile per branch and shape) and the port's twin; ``pt_idx``, ``pt_mask``,
the contact count and the overflow latch must be equal.  Every state is
kept off knife edges (a folded sheet is shifted off its own lattice, moving
nodes get seeded random displacements), where XLA's fused rounding and
eager PyTorch could decide a comparison differently.

Whole-slice runs (two ``create_tet_box``es, one thrown onto the other, and
a pile of five ``create_box``es) go through both packages' ``Solver`` with
their default arguments, the JAX package with ``dense_operator_max=0`` so
that both run Jacobi-PCG, and with ``unroll_loops=False`` (its PD
iterations as a fori_loop, traced once instead of four times).  Contact
counts and the latch must be equal on every tick; positions stay within a
tolerance set from the JAX package's own float32 spread on the scene
(``test_slice_matches_reference``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision.broadphase import detect_point_tri_collisions as jdetect
from pies_tpu.options import (
    CollisionBudget as JBudget,
    SolverName as JName,
    SolverOptions as JOptions,
    StepConfig as JConfig,
    make_params as jparams,
)
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.collision import broadphase as tb
from pies_tpu_torch.scene.contact_piles import add_box_pile, add_tet_boxes
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import step as tstep

from test_torch_super import _cloth, _fold
from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

_jdetect = jax.jit(jdetect, static_argnames=("config",))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _detect_both(x, prev, tris, mask, params, cfg):
    """Detection of both packages on the same numpy inputs (``params`` and
    ``cfg`` the JAX package's); asserts the results equal and returns the
    port's contact count and latch."""
    out = _jdetect(jnp.asarray(x), jnp.asarray(prev), jnp.asarray(tris), jnp.asarray(mask),
                   params, config=cfg)
    ji, jm, jo = np.asarray(out[0]), np.asarray(out[1]), bool(out[2])
    tcfg, tparams = convert.config_from(cfg), convert.params_from(_np(params))
    assert tb.tri_mode(tcfg, tris.shape[0]) is not None
    pi, pm, pc, po, rb = tb.detect_point_tri_collisions(
        torch.from_numpy(np.array(x)), torch.from_numpy(np.array(prev)),
        torch.from_numpy(np.array(mask)), tparams, tcfg,
        triangles=torch.from_numpy(np.array(tris)))
    n = int(pc[0])
    assert n == int(jm.sum()) and bool(po[0]) == jo and int(rb[0]) == 0
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_array_equal(pm.numpy(), jm)
    return n, jo


def _scene_inputs(j):
    """The JAX solver's next-substep detection inputs: the predicted
    positions, the previous ones, the triangles and their mask."""
    s, p = j._state, j.current_params()
    x = np.asarray(s.positions + p.dt * s.velocities * s.node_mask[:, None])
    topo = j._topology
    return x, np.asarray(s.prev_positions), np.asarray(topo.triangles), np.asarray(topo.tri_mask)


def _moved(x, seed, scale):
    """``x`` with a seeded random displacement of the live nodes."""
    rng = np.random.default_rng(seed)
    return (x + rng.uniform(-scale, scale, x.shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# scenes of the detection tests


def _sheet():
    """``create_sheet`` (the ``cloth_pd_20x20`` scene) folded over itself
    along x = 9.5: the folded half 0.06 over the other, shifted off the
    lattice; ``prev`` is the folded sheet, ``x`` moved from it."""
    j = pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0)
    j.create_sheet((0, 10, 0), 1.0, 1.0, 5000.0)
    j._prepare()
    p = np.array(j._state.positions)
    n = 400
    over = p[:n, 0] > 9.5
    p[:n][over] = p[:n][over] * np.float32([-1, 1, 1]) + np.float32([19.13, 0.06, 0.07])
    prev = p.copy()
    x = prev.copy()
    x[:n] = _moved(prev[:n], 1, 0.04)
    topo = j._topology
    return (x, prev, np.asarray(topo.triangles), np.asarray(topo.tri_mask),
            j.current_params(), j._config)


def _mini_pile(n_tets, spread, seed=0):
    """``n_tets`` random tets of side 0.5 crowded into a box of side
    ``spread`` (one body each, one per triangle row), every node moved a
    little: most rows overlap more than ``max_narrow_candidates`` others."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(0.0, spread, (n_tets, 3)).astype(np.float32)
    unit = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]) * np.float32(0.5)
    prev = (origins[:, None] + unit[None]).reshape(-1, 3).astype(np.float32)
    x = _moved(prev, seed + 1, 0.05)
    faces = np.int32([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    tris = (np.arange(n_tets, dtype=np.int32)[:, None, None] * 4 + faces[None]).reshape(-1, 3)
    mask = np.ones(tris.shape[0], np.float32)
    cfg = JConfig(solver=JName.PD, budget=JBudget(max_point_tri_contacts=4096))
    return x, prev, tris, mask, jparams(JOptions(), broadphase_cell=1.0), cfg


@pytest.mark.parametrize("case", ["sheet", "sheet_cut", "pile_n2", "pile_latch",
                                  "pile_cut"])
def test_allpairs_detection_equals_reference(case):
    """The all-pairs branch: the folded sheet (722 triangles), and dense
    mini-piles whose rows hold more than ``n1 = 32`` overlaps: 24 tets (96
    rows, ``n2 = 96``, no latch) and 40 tets (160 rows, ``n2 = 128``, the
    ``narrow_over`` latch).  The ``_cut`` cases cap the contact list at 40,
    which pins the chunk-major order of what survives."""
    if case.startswith("sheet"):
        x, prev, tris, mask, params, cfg = _sheet()
    else:
        x, prev, tris, mask, params, cfg = (
            _mini_pile(40, 0.2) if case == "pile_latch" else _mini_pile(24, 1.0))
    if case.endswith("_cut"):
        cfg = dataclasses.replace(cfg, budget=dataclasses.replace(
            cfg.budget, max_point_tri_contacts=40))
    assert tris.shape[0] <= cfg.allpairs_broadphase_max and cfg.budget.body_stride == 1
    lo = x[tris].min(1)
    hi = x[tris].max(1)
    n, latch = _detect_both(x, prev, tris, mask, params, cfg)
    assert latch == (case == "pile_latch")
    assert n == (40 if case.endswith("_cut") else n) and n > 0
    if case.startswith("pile"):
        # Rows past n1 overlaps: the n2 tier is what the JAX package ran.
        ov = ((lo[None] <= hi[:, None] + 0.1) & (hi[None] >= lo[:, None] - 0.1)).all(-1)
        assert ov.sum(1).max() > 32


def _celllist_cloth():
    """``test_torch_super._fold``'s folded 10 × 10 cloth with the super-body
    path switched off (as ``tests/test_collisions.py:784-805`` does):
    ``allpairs_broadphase_max = 0`` sends its 162 triangles to the cell
    list."""
    j = pies_tpu.Solver(JOptions(solver=JName.PD), allpairs_broadphase_max=0,
                        dense_operator_max=0)
    _cloth(j)
    j._prepare()
    _fold(j)
    cfg = dataclasses.replace(
        j._config, super_k=0, super_packed_k=0, super_packed_m=0, super_packed_off=0,
        super_live_k=0, super_faces=(), super_packed_e=0, super_loose_face=-1)
    return j, cfg


@pytest.mark.parametrize("moved", [False, True], ids=["folded", "moving"])
def test_celllist_detection_equals_reference(moved):
    """As folded, no latch; with the folded half's nodes moving, a row finds
    more than 32 unique overlapping candidates and ``exact_over`` latches."""
    j, cfg = _celllist_cloth()
    x, prev, tris, mask = _scene_inputs(j)
    if moved:
        x = x.copy()
        x[:100] = _moved(x[:100], 2, 0.03)
    assert tris.shape[0] > cfg.allpairs_broadphase_max
    n, latch = _detect_both(x, prev, tris, mask, j.current_params(), cfg)
    assert n > 0 and latch == moved


@pytest.mark.parametrize("move", [0.0, 0.03, 0.07])
def test_bodies_detection_equals_reference(move):
    """The per-body cell list: the 96-tet soup at spacing 1.0 (contacts from
    the first tick) with ``body_nodes = 0``, as built and with every node
    moved by up to ``move``.  At 0.07 a triangle's row holds more than its
    16 narrow slots of exactly overlapping candidates, and ``exact_over``
    latches."""
    j = pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0)
    j.create_tet_soup(96, spacing=1.0, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
    j._prepare()
    cfg = dataclasses.replace(j._config, body_nodes=0, body_node_offset=0, body_faces=())
    assert cfg.budget.body_stride == 4
    x, prev, tris, mask = _scene_inputs(j)
    x = x.copy()
    x[:384] = _moved(x[:384], 4, move)
    n, latch = _detect_both(x, prev, tris, mask, j.current_params(), cfg)
    assert n > 0 and latch == (move > 0.05)


def _crossing():
    """Two triangles, one crossing the other (``tests/test_collisions.py:
    119-149``), in reference mode with the quirks (world-unit cells)."""
    prev = np.float32([[0, 0, 0], [2, 0, 0], [0, 0, 2],
                       [0.3, 0.5, 0.3], [1.0, 0.5, 0.3], [0.3, 0.5, 1.0],
                       [1e5, 1e5, 1e5], [1e5, 1e5, 1e5]])
    x = prev.copy()
    x[3:6, 1] = -0.5
    tris = np.int32([[0, 1, 2], [3, 4, 5]])
    cfg = JConfig(solver=JName.PD, broadphase_mode="reference")
    return x, prev, tris, np.ones(2, np.float32), jparams(JOptions(), broadphase_cell=6.0), cfg


@pytest.mark.parametrize("case", ["crossing", "pile", "pile_no_quirks", "pile_cut"])
def test_reference_detection_equals_reference(case):
    """The reference's multi-cell sweep: the crossing pair, and the box pile
    with gaps of 0.05 (inside the CCD threshold of 0.1)
    with moving nodes, with the quirks (world-unit cells), without them
    (``grid_spacing`` cells), and with a cut contact list."""
    if case == "crossing":
        x, prev, tris, mask, params, cfg = _crossing()
        n, latch = _detect_both(x, prev, tris, mask, params, cfg)
        assert n == 3 and not latch
        return
    j = add_box_pile(pies_tpu.Solver(JOptions(solver=JName.PD), broadphase_mode="reference",
                              reference_quirks=case != "pile_no_quirks", dense_operator_max=0),
              gap=0.05)
    j._prepare()
    x, prev, tris, mask = _scene_inputs(j)
    x = _moved(x, 3, 0.02)
    cfg = j._config
    if case == "pile_cut":
        cfg = dataclasses.replace(cfg, budget=dataclasses.replace(
            cfg.budget, max_point_tri_contacts=64))
    n, _ = _detect_both(x, prev, tris, mask, j.current_params(), cfg)
    assert n > 0 and (n == 64) == (case == "pile_cut")


# ---------------------------------------------------------------------------
# the slice as a whole, ride-alongs and repairs


def _soup(s):
    """Eight tets at spacing 1.0 (contacts from the first tick), one
    collision body per triangle: the all-pairs branch on the tet-column
    path."""
    s.create_tet_soup(8, spacing=1.0, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
    return s


# Each scene with the Solver arguments it takes beside the defaults.
SLICE_SCENES = {"two_tet_boxes": (add_tet_boxes, {}), "box_pile": (add_box_pile, {}),
                "soup_one_body_per_triangle": (_soup, dict(budget_overrides={"body_stride": 1}))}
# Position tolerances of the 40-tick runs, from the JAX package's own spread
# (see test_slice_matches_reference).
SLICE_TOL = {"two_tet_boxes": 1e-3, "box_pile": 2e-4, "soup_one_body_per_triangle": 1e-3}
STEP_TOL = 1e-5


def _perturbed(j, seed, frac, ulps=1):
    """Move a random ``frac`` of the JAX solver's initial coordinates
    ``ulps`` float32 ulps up or down (positions and previous positions)."""
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
    """``ticks`` JAX ticks of a scene with the default arguments, its
    initial coordinates perturbed by ``_perturbed(j, *perturb)`` when given.
    Returns the solver, the positions after each tick and the contacts
    detected before each tick."""
    build, kw = SLICE_SCENES[scene]
    j = build(pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0, **kw))
    j._prepare()
    # (the PD iterations as a fori_loop, traced once instead of four times)
    j._config = dataclasses.replace(j._config, unroll_loops=False)
    if perturb is not None:
        _perturbed(j, *perturb)
    n = j._builder.num_nodes
    pos, counts, states = [], [], []
    for _ in range(ticks):
        x, prev, tris, mask = _scene_inputs(j)
        out = _jdetect(jnp.asarray(x), jnp.asarray(prev), jnp.asarray(tris),
                       jnp.asarray(mask), j.current_params(), config=j._config)
        counts.append(int(np.asarray(out[1]).sum()))
        states.append(j._state)
        j.tick()
        pos.append(np.asarray(j._state.positions)[:n])
    return j, np.stack(pos), counts, states


def jax_spread(scene, ticks=40, seeds=16):
    """The JAX package's own float32 spread on a slice scene: the largest
    distance over ``ticks`` between the unperturbed run and runs whose
    initial coordinates moved by ulps (``seeds`` seeds, each with a tenth,
    nine tenths and half of the coordinates, the last by 4 ulps)."""
    _, ref, _, _ = _jax_run(scene, ticks)
    return max(float(np.abs(_jax_run(scene, ticks, (seed, frac, ulps))[1] - ref).max())
               for seed in range(seeds) for frac, ulps in ((0.1, 1), (0.9, 1), (0.5, 4)))


@pytest.mark.parametrize("scene", list(SLICE_SCENES))
def test_slice_matches_reference(scene):
    """40 ticks through both packages' ``Solver`` with the default
    arguments (self-contact on: the all-pairs branch).  Contact counts and
    the latch equal on every tick, contacts present.  From the JAX state
    before ticks 10, 20 and 30, one port tick lands within 1e-5 of the JAX
    tick (measured <= 1.2e-6 on every tick of the tet boxes).

    Positions over the run within ``SLICE_TOL``, set from the JAX package's
    own spread (``jax_spread``: 48 runs started one to four float32 ulps
    away).  Two tet boxes: the spread is 2.6e-5 on most runs, but 2 of the
    48 take another branch at tick 31 and part by 3.96e-4; the port takes
    it too and parts by 3.94e-4,
    decaying to 8e-5 by tick 40.  Box pile: spread 5.0e-5, the port 4.8e-5.
    Eight tets, one collision body per triangle: spread 2.6e-2 (a tet comes
    to rest on the floor), the port 3.8e-4.  Those spreads are of the
    unrolled loop (the JAX default).  These runs take the rolled one, whose
    own spread is 4.0e-5, 5.8e-5 and 2.6e-2 (``jax_spread`` as it runs
    now) and which parts from the unrolled run by 1.3e-5, 3.3e-5 and 0;
    the port parts from it by 3.9e-4 (tick 33), 5.1e-5 and 3.8e-4.  On the
    tet boxes the port takes the tick-31 branch that none of the 48 rolled
    runs takes, and that the unrolled loop takes from one ulp away: the
    tolerances stay those set from the unrolled loop's spread, the JAX
    package's own float32 behaviour on the scene."""
    (build, kw), ticks = SLICE_SCENES[scene], 40
    j, ref, ref_counts, states = _jax_run(scene, ticks)
    t = build(pt.Solver(pt.SolverOptions(), device="cpu", **kw))
    assert tb.tri_mode(t.config, t.topology.tri_mask.shape[0]) == "allpairs"
    n = t._builder.num_nodes
    port, counts = [], []
    for _ in range(ticks):
        t.counters = tpd.new_counters("cpu")
        t.tick()
        counts.append(int(t.counters["contacts"]))
        port.append(t.state.positions[:n].numpy().copy())
    assert counts == ref_counts and sum(counts) > 0
    assert t.sim_failed == j.sim_failed == False  # noqa: E712
    err = float(np.abs(np.stack(port) - ref).max())
    assert err <= SLICE_TOL[scene], err
    topo = convert.topology_from_numpy(_np(j._topology))
    cfg, params = convert.config_from(j._config), convert.params_from(_np(j.current_params()))
    for tick in (10, 20, 30):
        st = convert.state_from_numpy(_np(states[tick]))
        tstep.tick(st, topo, params, cfg)
        np.testing.assert_allclose(st.positions[:n].numpy(), ref[tick], atol=STEP_TOL, rtol=0)


def test_ride_alongs_equal_reference():
    """``add_nodes``, ``get_lines``, ``get_triangles`` and ``clear`` (a new
    builder seeded with 0) against the JAX package's on one scene."""
    j = pies_tpu.Solver(JOptions(solver=JName.PD))
    t = pt.Solver(pt.SolverOptions(), device="cpu")
    free = np.float32([[0.5, 3.0, 0.5], [1.5, 3.0, 0.5]])
    for s in (j, t):
        s.create_box((0.0, 0.5, 0.0), 0.5, 1000.0)
        ids = s.add_nodes(free)
        np.testing.assert_array_equal(ids, [125, 126])
    np.testing.assert_array_equal(t.get_lines(), j.get_lines())
    np.testing.assert_array_equal(t.get_triangles(), j.get_triangles())
    for k in ("position", "radius"):
        np.testing.assert_array_equal(t.get_vertices()[k], j.get_vertices()[k])
    for s in (j, t):
        s.clear()
        s.create_tet_soup(8, spacing=1.6, scale=0.8, w=2000.0, jitter=0.05)
    np.testing.assert_array_equal(t.get_vertices()["position"], j.get_vertices()["position"])
    assert t.get_lines().shape == j.get_lines().shape == (0,)


def test_host_repairs():
    """``tick`` waits for the step and times it, ``last_residual`` takes a
    value, ``add_tri_mesh_volume`` is there, and the JAX ``Solver`` has no
    public method that the port's lacks."""
    s = add_tet_boxes(pt.Solver(pt.SolverOptions(), device="cpu"))
    s.tick()
    assert s.last_tick_seconds > 0.0
    s.last_residual = 2.5
    assert s.last_residual == 2.5
    assert callable(getattr(s, "add_tri_mesh_volume", None))
    public = lambda cls: {n for n in dir(cls) if not n.startswith("_")}  # noqa: E731
    assert not public(pies_tpu.Solver) - public(pt.Solver), \
        sorted(public(pies_tpu.Solver) - public(pt.Solver))


@pytest.mark.parametrize("scene,kw", [
    ("create_sheet", {}), ("create_box", {}), ("create_bend_sheet", {}),
    ("create_tet_box", {}), ("create_box", {"broadphase_mode": "reference"})],
    ids=["sheet", "box", "bend_sheet", "tet_box", "box_reference"])
def test_default_arguments_tick_every_reference_scene(scene, kw):
    """The reference's own primitives with the default ``Solver`` arguments
    (self-contact on) tick on the port, through the branch the JAX
    package's dispatch picks."""
    args = {"create_sheet": ((0, 10, 0), 1.0, 1.0, 5000.0),
            "create_box": ((0, 2, 0), 1.0, 1000.0),
            "create_bend_sheet": ((0, 2, 0), 0.5, 1000.0),
            "create_tet_box": ((0, 2, 0), 1.0, (0, 0, 0), 1500.0, 1.0)}[scene]
    s = pt.Solver(pt.SolverOptions(), device="cpu", **kw)
    getattr(s, scene)(*args)
    s.tick()
    expect = "reference" if kw else "allpairs"
    assert s.config.enable_collisions
    assert tb.tri_mode(s.config, s.topology.tri_mask.shape[0]) == expect
    assert not s.sim_failed and bool(torch.isfinite(s.state.positions).all())
