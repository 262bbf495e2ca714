"""The port's ensembles on the generic PD path with edge-edge and PD
node-node contacts (``pies_tpu_torch.parallel.ensemble``, ROADMAP item
10b-iii) against the JAX package's vmapped ``ensemble_tick``.

Cases (the JAX solvers with ``dense_operator_max=0`` and
``unroll_loops=False``, the ``fori_loop`` form the JAX package prescribes
for vmapped rollouts; member 0 as built, each other member's live nodes
moved by its own seeded offset, uniform ±0.02):

* ``strips`` and ``strips_quirks``: the crossing strips of
  ``tests/test_collisions.py:254-300`` (``tests/test_torch_edges.py``'s
  scene, its quirk-mode variant under ``reference_quirks=True``), edge-edge
  contacts alone under recentered coupling, B = 3 with member 2 latched
  before the start;
* ``nets``: the 6 x 6 crossing nets with ``edge_nets.solver_args()`` (edge
  and point-triangle contacts, full coupling, caps 2,048), B = 2 from tick
  15 (edge contacts from tick 16); the jitter leaves no exactly parallel
  edge pair, the knife edge of ``tests/test_torch_edges.py``'s docstring;
* ``cloud``: a 256-node PD node cloud (``add_node_pile``, node-node
  contacts alone, cap 16 n), B = 3 with member 1 latched, from tick 2.

Each JAX ensemble warms, its state is carried across with
``convert.state_from_numpy`` (a PD state has no node-pair cache: the pair
prefix is rebuilt every substep) and both packages step the same arrays for
``TICKS`` ticks.  On the JAX package's state before every tick each
member's edge contacts and node pairs are detected by both packages from
the predicted positions of the tick's first substep (the port's detections
batched) and must be equal as sets; the latch fires on the same tick
(never here).  The reference is compiled at XLA's backend optimization
level 0 (``XLA_OPTS``, below).

Tolerances (measured on the CPU).  One tick: 3e-6, or where larger 3x the
JAX package's own one-tick spread (the farthest its first tick moves from
the start with half the live coordinates moved one ulp, four seeds): the
strips part by 0, the cloud by at most 4.8e-7; the nets' w = 1e6 edge
blocks under a 16-trip CG amplify roundings within a tick
(``tests/test_torch_edge_ticks.py`` holds their single-scene tick to that
spread too), its spread is 3.0e-5 to 5.3e-5 and the port parts by 3.7e-5
to 4.1e-5 (at most 1.21x).  Over the window each member within 3x the JAX
package's own float32 spread on it (its window from the start with half
the live coordinates moved one ulp, the largest gap over the window;
``tests/test_torch_ensemble_generic.py``'s factor): spreads of 1.4e-6 to
2.3e-5 (strips), 1.7e-4 to 2.0e-4 (nets) and 2.4e-5 to 3.5e-5 (cloud); the
port parts by at most 8.7e-11 on the strips, 2.4e-4 on the nets (1.36x)
and 2.0e-5 on the cloud (0.57x).  The latched member is bit-unchanged with
residual 0 in both packages.

Within the port, without JAX: every member equals its single-scene run,
counters included; ``ensemble_tick_n`` equals that many ticks and
``ensemble_step`` reduces over the members; the per-member edge and pair
counters of the nets and the cloud at B = 2 equal each member's own.

The ``gpu`` tests hold each batched stage of the path (T16's edge
candidates, T25, T26's setup and terms in T9 and T10, T8's edge pass, T20,
T27's setup and friction and its force in T9, T4) at B = 3 with a latched
member to its twins' member loop on identical inputs, bit for bit, and
B = 1 to the unbatched call, on the nets in both quirk modes, the cloud and
the nets with every contact on under recentered coupling; they skip
without a card.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision.broadphase import detect_edge_edge_collisions as jedge
from pies_tpu.collision.broadphase import detect_node_node_pairs as jnode
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.parallel import ensemble as jens
from pies_tpu_torch import convert
from pies_tpu_torch.collision import broadphase
from pies_tpu_torch.collision.batches import node_pairs_of
from pies_tpu_torch.parallel import ensemble
from pies_tpu_torch.scene.contact_piles import branch_scene, jitter_offsets, jittered_ensemble
from pies_tpu_torch.scene.edge_nets import add_crossing_nets, nets_ensemble, solver_args
from pies_tpu_torch.scene.pbd_scenes import add_node_pile, cloud_ensemble
from pies_tpu_torch.solver import pd, step, tetcols
from pies_tpu_torch.solver.stages import contact_stages, stages_apart
from pies_tpu_torch.state import clone_state, member, unstack

from test_torch_edges import _strips, _strips_args
from torch_threads import two_threads  # noqa: F401

TICKS = 8
STEP_TOL = 3e-6
# The reference's ticks and detections are compiled at XLA's backend
# optimization level 0: its LLVM passes otherwise contract and reorder the
# float32 arithmetic, which on the free-flying strips biases every tick the
# same way (the jitted JAX run parts from the JAX package's own op-by-op
# run by 1.2e-5 in 9 ticks, 6x its one-ulp spread, while the port's run
# equals the op-by-op run bit for bit, on the CPU).  At level 0 the jitted
# run follows the op-by-op one to within 2e-11 there.
XLA_OPTS = {"xla_backend_optimization_level": 0}
SPREAD_FACTOR = 3.0
FIELDS = ("positions", "prev_positions", "velocities", "forces", "sim_failed")
CLOUD_N = 256


def _jax_solver(case):
    if case.startswith("strips"):
        quirks = case == "strips_quirks"
        return _strips(pies_tpu.Solver(JOptions(solver=JName.PD, gravity=0.0),
                                       dense_operator_max=0,
                                       **_strips_args(quirks, "recentered")),
                       quirk_geometry=quirks)
    if case == "nets":
        return add_crossing_nets(pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0,
                                                 **solver_args()), 6)
    return add_node_pile(pies_tpu.Solver(
        JOptions(solver=JName.PD), dense_operator_max=0, enable_collisions=False,
        enable_node_collisions=True,
        budget_overrides=dict(max_node_node_contacts=16 * CLOUD_N)), CLOUD_N)


# case -> (members, latched member, warm-up ticks)
CASES = {"strips": (3, 2, 1), "strips_quirks": (3, 2, 1), "nets": (2, None, 15),
         "cloud": (3, 1, 2)}


def _moved(state, live, seed):
    """A JAX ensemble state with half its live coordinates moved one ulp up
    or down (seeded), as device arrays."""
    rng = np.random.default_rng(seed)
    x = state.positions[:, :live]
    inf = np.where(rng.random(x.shape) < 0.5, np.float32(np.inf), np.float32(-np.inf))
    moved = np.where(rng.random(x.shape) < 0.5, np.nextafter(x, inf), x)
    return jax.tree.map(jax.numpy.asarray, dataclasses.replace(
        state, positions=np.concatenate([moved, state.positions[:, live:]], axis=1)))


def _rows(idx, mask):
    """Each member's live contact rows as a set of tuples."""
    return [{tuple(int(v) for v in row) for row, m in zip(i, k) if m > 0}
            for i, k in zip(np.asarray(idx), np.asarray(mask))]


@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    """The JAX ensemble of a case: its start after the warm-up (NumPy
    leaves), then per tick of the window the positions, residuals, latch
    and each member's edge and pair sets, and its own float32 spread per
    member."""
    case = request.param
    members, latched, warm = CASES[case]
    j = _jax_solver(case)
    j._prepare()
    topo, params = j._topology, j.current_params()
    cfg = dataclasses.replace(j._config, unroll_loops=False)
    live = j._builder.num_nodes
    st = jax.tree.map(lambda a: np.repeat(np.asarray(a)[None], members, 0), j._state)
    off = jitter_offsets(members, live, seed0=100)
    pos, prev = st.positions.copy(), st.prev_positions.copy()
    pos[:, :live] += off
    prev[:, :live] += off
    failed = np.zeros(members, bool)
    if latched is not None:
        failed[latched] = True
    st = dataclasses.replace(st, positions=pos, prev_positions=prev, sim_failed=failed)
    edges, nodes = cfg.enable_edge_collisions, cfg.enable_node_collisions

    def contacts(states):
        def one(s):
            x = s.positions + params.dt * s.velocities * s.node_mask[:, None]
            out = []
            if edges:
                ei, em, _ = jedge(x, s.prev_positions, topo.triangles, topo.tri_mask, params, cfg)
                out += [ei, jax.numpy.where(s.sim_failed, 0.0, em)]
            if nodes:
                ni, nm = jnode(s, x, params, cfg)
                out += [ni, jax.numpy.where(s.sim_failed, 0.0, nm)]
            return out
        return jax.vmap(one)(states)

    states = jax.tree.map(jax.numpy.asarray, st)
    tick = jax.jit(lambda s: jens.ensemble_tick(s, topo, params, cfg)).lower(states).compile(
        compiler_options=XLA_OPTS)
    contacts = jax.jit(contacts).lower(states).compile(compiler_options=XLA_OPTS)
    for _ in range(warm):
        states, _ = tick(states)
    start = jax.tree.map(np.asarray, states)
    xs, res, latch, sets, inputs = [], [], [], [], []
    for _ in range(TICKS):
        inputs.append(jax.tree.map(np.asarray, states))
        found = contacts(states)
        sets.append([_rows(*found[k:k + 2]) for k in range(0, len(found), 2)])
        states, r = tick(states)
        xs.append(np.asarray(states.positions)[:, :live])
        res.append(np.asarray(r))
        latch.append(np.asarray(states.sim_failed).tolist())
    states = _moved(start, live, 7)
    spread = np.zeros(members)
    for k in range(TICKS):
        states, _ = tick(states)
        gap = np.abs(np.asarray(states.positions)[:, :live] - xs[k]).reshape(members, -1)
        spread = np.maximum(spread, gap.max(1))
    spread1 = np.zeros(members)  # the first tick's, over four seeds
    for seed in range(8, 12):
        gap = np.abs(np.asarray(tick(_moved(start, live, seed))[0].positions)[:, :live] - xs[0])
        spread1 = np.maximum(spread1, gap.reshape(members, -1).max(1))
    return dict(case=case, start=start, pos=np.stack(xs), res=res, latch=latch, sets=sets,
                inputs=inputs, spread=spread, spread1=spread1, live=live, topo=jax.tree.map(np.asarray, topo), cfg=cfg,
                params=jax.tree.map(np.asarray, params))


def _port(ref):
    cfg = ref["cfg"]
    return (convert.state_from_numpy(ref["start"]),
            convert.topology_from_numpy(ref["topo"], tet_fused=cfg.tet_fused),
            convert.params_from(ref["params"]), convert.config_from(cfg))


def _port_contacts(states, topo, params, cfg):
    """Each member's edge contacts and node pairs of the next tick's first
    substep, each family detected in one batched call."""
    h = float(np.float32(params.dt))
    x = states.positions + h * states.velocities * states.node_mask[..., None]
    failed, out = states.sim_failed, []
    if cfg.enable_edge_collisions:
        ov = torch.zeros(failed.shape[:-1] + (1,), dtype=torch.int32)
        ei, em, _, _ = broadphase.detect_edge_edge_collisions(
            x, states.prev_positions, topo.triangles, topo.tri_mask, params, cfg, ov, failed)
        out.append(_rows(ei.numpy(), em.numpy()))
    if cfg.enable_node_collisions:
        nn = broadphase.detect_node_node_pairs(x, states.radius, states.node_mask, params, cfg,
                                               failed)
        pairs = [node_pairs_of(member(nn, b), cfg.budget.max_node_node_contacts)
                 for b in range(states.members)]
        out.append(_rows(np.stack([i.numpy() for i, _ in pairs]),
                         np.stack([m.numpy() for _, m in pairs])))
    return out


@pytest.fixture(scope="module")
def port_run(reference):
    """The port's window: positions, residuals, per-member counters and
    contact sets per tick, the final state and the start."""
    states, topo, params, cfg = _port(reference)
    start = clone_state(states)
    pos, counts, res, latch = [], [], [], []
    # each tick's detections on the JAX package's inputs of that tick
    sets = [_port_contacts(convert.state_from_numpy(s), topo, params, cfg)
            for s in reference["inputs"]]
    for _ in range(TICKS):
        c = pd.new_counters("cpu", states.members)
        res.append(ensemble.ensemble_tick(states, topo, params, cfg, counters=c).numpy())
        pos.append(states.positions[:, :reference["live"]].numpy().copy())
        counts.append({k: v.tolist() for k, v in c.items()})
        latch.append((states.sim_failed != 0).any(-1).tolist())
    return dict(pos=np.stack(pos), counts=counts, res=res, sets=sets, latch=latch,
                states=states, start=start, env=(topo, params, cfg))


def test_the_case_takes_the_generic_path(reference):
    """The vmapped JAX state carries across (no node-pair cache on PD) and
    the case runs on the generic path with its contact families."""
    states, topo, _, cfg = _port(reference)
    members, latched, _ = CASES[reference["case"]]
    case = reference["case"]
    assert states.members == members and states.nn is None and states.bp is None
    assert states.sim_failed[:, 0].tolist() == [int(b == latched) for b in range(members)]
    assert not tetcols.applies(states, topo, cfg)
    assert pd.edge_contact(cfg, topo) == (case != "cloud")
    assert cfg.enable_node_collisions == (case == "cloud")
    assert pd.self_contact(cfg, topo) == (case == "nets")
    if case.startswith("strips"):
        assert cfg.reference_quirks == (case == "strips_quirks")


def test_one_tick_matches_reference(reference, port_run):
    """The first tick within 3e-6 of the JAX tick, or where larger within
    3x the JAX package's own one-tick spread."""
    d = np.abs(port_run["pos"][0] - reference["pos"][0]).reshape(len(reference["spread"]), -1)
    tol = np.maximum(STEP_TOL, SPREAD_FACTOR * reference["spread1"])
    assert (d.max(1) <= tol).all(), (d.max(1), reference["spread1"])


def test_window_matches_reference(reference, port_run):
    """Each member within 3x the JAX package's own spread; edge and pair
    sets on each tick's identical inputs equal per member, and live in
    every unlatched member; the latch on the same tick; the latched member
    bit-unchanged, residual 0 and counting nothing."""
    members, latched, _ = CASES[reference["case"]]
    assert port_run["sets"] == reference["sets"]
    assert port_run["latch"] == [[bool(f) for f in t] for t in reference["latch"]]
    gate = "node_pairs" if reference["case"] == "cloud" else "edge_contacts"
    d = np.abs(port_run["pos"] - reference["pos"]).reshape(TICKS, members, -1).max(-1)
    for b in range(members):
        if b == latched:
            assert not d[:, b].any() and all(float(r[b]) == 0.0 for r in reference["res"])
            assert all(float(r[b]) == 0.0 for r in port_run["res"])
            assert all(c[k][b] == 0 for c in port_run["counts"] for k in c)
            assert not any(f[b] for s in port_run["sets"] for f in s)
            continue
        assert sum(c[gate][b] for c in port_run["counts"]) > 0, b
        assert all(any(s[k][b] for s in reference["sets"]) for k in range(len(reference["sets"][0])))
        assert 0.0 < reference["spread"][b]
        assert (d[:, b] <= SPREAD_FACTOR * reference["spread"][b]).all(), (
            b, d[:, b], reference["spread"][b])
    assert np.isfinite(port_run["pos"]).all()


def test_members_equal_their_single_scene_runs(reference, port_run):
    """Every member, every counter per tick included, bit-equal to its
    single-scene run."""
    topo, params, cfg = port_run["env"]
    states = port_run["states"]
    for b in range(states.members):
        single = unstack(port_run["start"], b)
        for t in range(TICKS):
            c = pd.new_counters("cpu")
            step.tick(single, topo, params, cfg, counters=c)
            for k in c:
                assert int(c[k]) == port_run["counts"][t][k][b], (b, t, k)
        after = member(states, b)
        for f in FIELDS:
            assert torch.equal(getattr(after, f), getattr(single, f)), (b, f)


# ---------------------------------------------------------------------------
# within the port: tick_n and step, the counters


def test_tick_n_and_step_reduce_over_members():
    """The 256-node cloud at B = 3 with member 2 latched:
    ``ensemble_tick_n(3)`` equals three ``ensemble_tick`` calls and returns
    the largest last residual; ``ensemble_step`` returns that and the
    latched count."""
    s, a = cloud_ensemble(3, CLOUD_N, "cpu", seed0=100)
    topo, params, cfg = s.topology, s.current_params(), s.config
    a.sim_failed[2, 0] = 1
    b, c = clone_state(a), clone_state(a)
    res_n = ensemble.ensemble_tick_n(a, topo, params, cfg, 3)
    for _ in range(3):
        res = ensemble.ensemble_tick(b, topo, params, cfg)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert float(res_n) == float(res.max()) and float(res[2]) == 0.0 and float(res[:2].min()) > 0
    for _ in range(2):
        ensemble.ensemble_tick(c, topo, params, cfg)
    max_res, num_failed = ensemble.ensemble_step(c, topo, params, cfg)
    assert float(max_res) == float(res.max()) and int(num_failed) == 1
    assert torch.equal(c.positions, b.positions)


@pytest.mark.parametrize("scene", ["nets", "cloud"])
def test_counters_are_per_member(scene):
    """B = 2 (the nets from tick 15, the cloud from the start): each
    member's edge contacts, edge hits, node pairs and touching pairs, and
    every other counter, equal its own single-scene counters on every tick,
    and the members' counts differ."""
    s, states = (nets_ensemble(2, 6, "cpu", seed0=100) if scene == "nets"
                 else cloud_ensemble(2, CLOUD_N, "cpu", seed0=100))
    topo, params, cfg = s.topology, s.current_params(), s.config
    if scene == "nets":
        ensemble.ensemble_tick_n(states, topo, params, cfg, 15)
    singles = [unstack(states, b) for b in range(2)]
    keys = ("edge_contacts", "edge_hits") if scene == "nets" else ("node_pairs",
                                                                   "touching_pairs")
    per_member = []
    for _ in range(3):
        c = pd.new_counters("cpu", 2)
        ensemble.ensemble_tick(states, topo, params, cfg, counters=c)
        for b, single in enumerate(singles):
            cs = pd.new_counters("cpu")
            step.tick(single, topo, params, cfg, counters=cs)
            assert all(int(cs[k]) == int(c[k][b]) for k in cs), (b, cs, c)
        per_member.append([c[k].tolist() for k in keys])
    per_member = np.asarray(per_member)  # [tick, key, member]
    assert per_member.sum(0).min() > 0 and (per_member[..., 0] != per_member[..., 1]).any()


# ---------------------------------------------------------------------------
# the batched kernels on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


SCENES = ("nets", "nets_quirks", "cloud", "all_on")


def edge_scene(kind, dev, members=3):
    """A ``members``-member ensemble (seeds 100 + b) on ``dev`` of a scene
    with edge-edge or node-node contacts, warmed by the kernels to a tick
    where they are live: the 6 x 6 nets (full coupling, or quirk mode) from
    tick 17, the 256-node cloud from tick 2, the tet boxes with all three
    contact families under recentered coupling
    (``contact_piles.branch_scene("all_on")``) from tick 10.  Returns
    ``(states, topology, params, config)``."""
    if kind == "cloud":
        s, states = cloud_ensemble(members, CLOUD_N, dev, seed0=100)
    elif kind == "all_on":
        s, cfg = branch_scene("all_on", dev)
        states = jittered_ensemble(s.state, members, s._builder.num_nodes, seed0=100)
    else:
        kw = dict(reference_quirks=True) if kind == "nets_quirks" else {}
        s, states = nets_ensemble(members, 6, dev, seed0=100, **kw)
    env = (s.topology, s.current_params(), s.config)
    ensemble.ensemble_tick_n(states, *env, {"cloud": 2, "all_on": 10}.get(kind, 17))
    return (states,) + env


def test_edge_stages_run_on_the_cpu():
    """The stage chain the card tests and ``chip_smoke.py`` phase 17c hold
    kernel against twin runs on the CPU (where every wrapper takes its
    twin) with every contact family on, each stage's two outputs equal."""
    states, topo, params, cfg = edge_scene("all_on", "cpu")
    states.sim_failed[2, 0] = 1
    out = contact_stages(states, topo, params, cfg)
    assert {"detection", "edge detection", "T20", "T27 setup", "T26 setup", "T9 stage 2",
            "T10", "T11", "T8", "T27 friction", "T8 friction", "T4"} <= set(out)
    assert stages_apart(out, [0, 1]) == []
    live = [out[k].kernel[i][:, 0].tolist() for k, i in (
        ("detection", 2), ("edge detection", 2), ("T27 setup", 0), ("T27 friction", 1))]
    assert all(c[2] == 0 and min(c[:2]) > 0 for c in live), live


@pytest.mark.gpu
@pytest.mark.parametrize("scene", SCENES)
def test_batched_edge_kernels_equal_the_twins_member_loop(cuda, scene):
    """B = 3 with member 2 latched: every stage's kernel outputs equal its
    twins' member loop on identical inputs, bit for bit."""
    states, topo, params, cfg = edge_scene(scene, cuda)
    states.sim_failed[2, 0] = 1  # a latched member in the batch
    out = contact_stages(states, topo, params, cfg)
    torch.cuda.synchronize()
    assert stages_apart(out, [0, 1]) == []
    key = ("T27 setup", 0) if scene == "cloud" else ("edge detection", 2)
    counts = out[key[0]].kernel[key[1]][:, 0].tolist()
    assert counts[2] == 0 and min(counts[:2]) > 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("scene", SCENES)
def test_one_member_equals_the_single_scene_edge_kernels(cuda, scene):
    """B = 1 gives the unbatched call's outputs, bit for bit."""
    states, topo, params, cfg = edge_scene(scene, cuda, members=1)
    batched = contact_stages(states, topo, params, cfg, twins=False)
    single = contact_stages(unstack(states, 0), topo, params, cfg, twins=False)
    torch.cuda.synchronize()
    for stage in batched:
        for a, b in zip(batched[stage].kernel, single[stage].kernel):
            assert torch.equal(a.reshape(b.shape), b), stage
