"""The domain decomposition's scenes run by both packages, shared by the
``test_torch_domain*.py`` files.

:data:`SCENES` holds the six scenes of the JAX package's domain tests
(``tests/test_parallel.py:226-358``) and a seventh, boxes on the floor
without stabilization passes; each builder works on either package's
``Solver``.  :func:`run_case` builds a scene with the JAX ``Solver``,
partitions it with the JAX package's ``partition_domain``, compiles its
``make_domain_tick`` once on the virtual CPU mesh (at XLA's backend
optimization level 0, ``OPT0``) and records ``JAX_TICKS`` domain ticks;
the port starts from the same partition
(``convert.domain_from_numpy``) and runs its own ``JAX_TICKS`` domain
ticks.  Where the port parts from the JAX domain by more than 3e-6, the JAX
package's own domain-against-single spread is measured too (as many
single-device ticks of the Solver's own tick).  The first tick's
predicted views are kept for the contact-set comparison on identical
inputs.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import pies_tpu
from pies_tpu.options import CollisionBudget as JBudget, SolverOptions as JOptions
from pies_tpu.collision import broadphase as jbroad
from pies_tpu.parallel import domain as jdomain, ensemble as jens
from pies_tpu.solver import step as jstep
from pies_tpu_torch import convert
from pies_tpu_torch.collision import broadphase
from pies_tpu_torch.parallel import domain, halo


def rope(s):
    s.create_rope((0, 8, 0), (6, 8, 0), 64, w=10000.0)


def tet_boxes(s):
    for i in range(4):
        s.create_tet_box((3.0 * i, 2.0, 0.0), 1.0, (0, 0, 0), w=1500.0, mass=1.0)


def shape_boxes(s):
    for i in range(8):
        s.create_shape_matching_box((2.0 * i, 1.5, 0.0), 3, 3, 3, 0.5, (0, 0, 0), w=500.0)


def pile(s):
    """Two colliding pairs of tet boxes; the second pads the node count so
    that the collision halo fits inside a block."""
    for x0 in (0.0, 4.5):
        s.create_tet_box((x0, 1.2, 0.0), 1.0, (0, 0, 0), w=1500.0, mass=1.0)
        s.create_tet_box((x0 + 1.4, 2.6, 0.0), 1.0, (0, 0, 0), w=1500.0, mass=1.0)


def floor_boxes(s):
    """Four tet boxes moving into the floor, without stabilization passes
    (where both packages snap no floor-active node)."""
    for i in range(4):
        s.create_tet_box((3.0 * i, 0.04, 0.0), 1.0, (0, -2.0, 0), w=1500.0, mass=1.0)


def edge_strips(s):
    """Three crossing pairs of wireframe strips along x, the middle pair
    across the slab boundary."""
    b = s._builder
    for x0 in (0.0, 3.0, 6.0):
        b._emit_nodes(np.array([[x0 - 1, 1, 0], [x0 + 1, 1, 0], [x0, 2.5, 0]], np.float32),
                      inv_mass=1.0, radius=0.1)
        b._emit_nodes(np.array([[x0, 1.02, -1], [x0, 1.02, 1], [x0, 2.5, 0.8]], np.float32),
                      inv_mass=1.0, radius=0.1)
    for t in np.arange(18, dtype=np.int32).reshape(6, 3):
        b.triangles.append(t[None, :])
    s._dirty = True


def node_line(s):
    """A line of 64 overlapping PD spheres across both slabs."""
    xs = np.arange(64, dtype=np.float32) * 0.5
    pts = np.stack([xs, np.full(64, 5.0, np.float32), np.zeros(64, np.float32)], axis=1)
    s._builder._emit_nodes(pts, inv_mass=1.0, radius=0.3)
    s._dirty = True


# name -> (builder, slabs, ticks, trajectory bound, SolverOptions fields,
#          Solver arguments, collision_margin); the budget of the node line
# is ``max_node_node_contacts`` (the single scene keeps all ~274 pairs).
SCENES = {
    "rope": (rope, 2, 30, 1e-4, {}, {}, 0.0),
    "tet_boxes": (tet_boxes, 4, 40, 1e-4, {}, {}, 0.0),
    "shape_boxes": (shape_boxes, 8, 25, 1e-4, {}, {}, 0.0),
    "pile": (pile, 2, 45, 2e-2, {}, dict(enable_collisions=True), 1.3),
    "floor_boxes": (floor_boxes, 4, 40, 1e-4, dict(collision_stabilization_iterations=0), {},
                    0.0),
    "edge_strips": (edge_strips, 2, 10, 1e-3, dict(gravity=0.0),
                    dict(enable_edge_collisions=True, reference_quirks=False), 2.5),
    "node_line": (node_line, 2, 15, 1e-3,
                  dict(gravity=0.0, iterations=8, collision_stabilization_iterations=0),
                  dict(enable_node_collisions=True, cg_iterations=32, cg_rtol=0.0,
                       budget=512), 4.0),
}


def solver_args(name: str, budget_cls) -> tuple[dict, dict]:
    """``(SolverOptions fields, Solver arguments)`` of a scene, the budget
    built with the package's ``CollisionBudget`` ``budget_cls``."""
    _, _, _, _, opts, kw, _ = SCENES[name]
    kw = dict(dict(enable_collisions=False), **kw)
    if "budget" in kw:
        kw["budget"] = budget_cls(max_node_node_contacts=kw["budget"])
    return dict(opts), kw


def build(name: str, solver_cls, options_cls, budget_cls, **extra):
    """A prepared ``Solver`` of the scene (either package's classes)."""
    opts, kw = solver_args(name, budget_cls)
    s = solver_cls(options_cls(**opts), **kw, **extra)
    SCENES[name][0](s)
    s._prepare()
    return s


JAX_TICKS = 10
STEP_TOL = 3e-6
SPREAD_FACTOR = 3.0
# The JAX ticks compile at XLA's backend optimization level 0: half the
# compile time, and no LLVM rewrite of the float32 arithmetic (at the
# default level it parts the JAX package's free-flying strips from its own
# op-by-op run; ``tests/test_torch_ensemble_edges.py``).
OPT0 = {"xla_backend_optimization_level": 0}


def jax_scene(name):
    return build(name, pies_tpu.Solver, JOptions, JBudget)


def numpy_scene(s):
    """The prepared JAX scene's state, topology, parameters, configuration
    and live node count (NumPy leaves)."""
    return (jax.tree.map(np.asarray, s._state), jax.tree.map(np.asarray, s._topology),
            s.current_params(), s._config, s._builder.num_nodes)


def run_case(name):
    _, n_slabs, _, _, _, _, margin = SCENES[name]
    s = jax_scene(name)
    state0, topo0, params, cfg, n_live = numpy_scene(s)
    jdom = jdomain.partition_domain(state0, topo0, n_slabs=n_slabs, collision_margin=margin)
    mesh = jens.make_mesh(n_slabs, axis="x")
    sh = NamedSharding(mesh, P("x"))
    put = lambda a: jax.device_put(jnp.asarray(a), sh)  # noqa: E731
    dstate = jax.tree.map(put, jdom.state)
    dstatic = jax.tree.map(put, jdom.static)
    dtick = jdomain.make_domain_tick(mesh, cfg, jdom.meta).lower(
        dstate, dstatic, params).compile(compiler_options=OPT0)
    jax_dom, jax_failed = [], []
    for _ in range(JAX_TICKS):
        dstate, _ = dtick(dstate, dstatic, params)
        jax_dom.append(jdomain.gather_positions(jdom, dstate)[:n_live])
        jax_failed.append(bool(np.any(np.asarray(dstate.sim_failed))))

    pdom = convert.domain_from_numpy(jdom, "cpu")
    pparams = convert.params_from(jax.tree.map(np.asarray, params))
    pcfg = convert.config_from(cfg)
    views = predicted_views(pdom, pparams)
    ptick = domain.make_domain_tick(pcfg, pdom.meta, device="cpu")
    port_dom, port_failed = [], []
    for _ in range(JAX_TICKS):
        ptick(pdom.state, pdom.static, pparams)
        port_dom.append(domain.gather_positions(pdom, pdom.state)[:n_live])
        port_failed.append(bool(pdom.state.sim_failed.any()))
    jax_dom, port_dom = np.stack(jax_dom), np.stack(port_dom)
    jax_single = None
    apart = np.abs(port_dom - jax_dom).reshape(JAX_TICKS, -1).max(1)
    if apart[0] > STEP_TOL or apart[-1] > STEP_TOL:
        # The JAX package's own spread is needed only past 3e-6 (its single
        # tick's compile is the case's dearest step).
        stick = jax.jit(jstep.tick, static_argnames=("config",), compiler_options=OPT0)
        single, jax_single = s._state, []
        for _ in range(JAX_TICKS):
            single, _ = stick(single, s._topology, params, config=cfg)
            jax_single.append(np.asarray(single.positions)[:n_live])
        jax_single = np.stack(jax_single)
    return dict(name=name, jdom=jdom, cfg=cfg, params=params, pcfg=pcfg, pparams=pparams,
                n_live=n_live, jax_dom=jax_dom, jax_single=jax_single,
                jax_failed=jax_failed, port_dom=port_dom, port_failed=port_failed,
                views=views, state0=state0, topo0=topo0,
                jax_final={f: np.asarray(getattr(dstate, f)) for f in (
                    "positions", "prev_positions", "velocities", "shape_quats", "sim_failed")},
                port_final=convert.domain_state_to_numpy(pdom.state))


def predicted_views(pdom, params):
    """The first substep's predicted positions and the start positions over
    each slab's view, f32[D, V, 3] each (the detection's inputs)."""
    st, sc = pdom.state, pdom.static
    h = float(np.float32(params.dt))
    mask = sc.node_mask_view[:, pdom.meta.halo:pdom.meta.halo + pdom.meta.block, None]
    x_own = st.positions + h * st.velocities * mask
    return (halo.refresh_plain(x_own, pdom.meta.halo),
            halo.refresh_plain(st.prev_positions, pdom.meta.halo))


def bounds(case):
    """The one-tick and ten-tick bounds: 3e-6, or 3x the JAX package's own
    domain-against-single-device spread where that is larger (measured
    only where the port parts by more than 3e-6)."""
    ticks = len(case["jax_dom"])  # (JAX_TICKS, or fewer where a test runs fewer)
    if case["jax_single"] is None:
        return STEP_TOL, STEP_TOL, np.zeros(ticks)
    spread = np.abs(case["jax_dom"] - case["jax_single"]).reshape(ticks, -1).max(1)
    return (max(STEP_TOL, SPREAD_FACTOR * spread[0]),
            max(STEP_TOL, SPREAD_FACTOR * spread[-1]), spread)


def check_against_jax(case):
    one, ten, spread = bounds(case)
    d = np.abs(case["port_dom"] - case["jax_dom"]).reshape(JAX_TICKS, -1).max(1)
    assert d[0] <= one, (d[0], one, spread[0])
    assert d[-1] <= ten, (d[-1], ten, spread[-1])
    assert case["port_failed"] == case["jax_failed"]
    assert np.isfinite(case["port_dom"]).all()
    # The way back to the JAX layout: every leaf's shape and dtype, the latch
    # per slab, and the shape groups' rotations after the window.
    jf, pf = case["jax_final"], case["port_final"]
    for f in jf:
        assert pf[f].shape == jf[f].shape and pf[f].dtype == jf[f].dtype, f
    assert np.array_equal(pf["sim_failed"], jf["sim_failed"])
    assert np.abs(pf["shape_quats"] - jf["shape_quats"]).max() <= 1e-4


def jax_domain_config(cfg):
    """The configuration the JAX domain tick rewrites to
    (``pies_tpu/parallel/domain.py:990-1000``)."""
    return dataclasses.replace(cfg, body_nodes=0, body_node_offset=0, body_faces=(),
                               budget=dataclasses.replace(cfg.budget, body_stride=1))


def port_single(name, ticks):
    """The port's own single scene and its domain from one partition after
    ``ticks`` ticks each: ``(domain positions, single positions, domain
    latch, single latch)`` over the live nodes."""
    import pies_tpu_torch as pt
    from pies_tpu_torch.options import CollisionBudget
    from pies_tpu_torch.solver import step
    from pies_tpu_torch.state import clone_state

    _, n_slabs, _, _, _, _, margin = SCENES[name]
    s = build(name, pt.Solver, pt.SolverOptions, CollisionBudget, device="cpu")
    dom = domain.partition_domain(clone_state(s.state), s.topology, n_slabs,
                                  collision_margin=margin)
    tick = domain.make_domain_tick(s.config, dom.meta)
    params = s.current_params()
    n = s._builder.num_nodes
    one = None
    for t in range(ticks):
        tick(dom.state, dom.static, params)
        step.tick(s.state, s.topology, params, s.config)
        if t == 0:
            one = np.abs(domain.gather_positions(dom, dom.state)[:n]
                         - s.state.positions[:n].numpy()).max()
    err = np.abs(domain.gather_positions(dom, dom.state)[:n] - s.state.positions[:n].numpy()).max()
    return one, err, bool(dom.state.sim_failed.any()), s.state.failed()


# ---------------------------------------------------------------------------
# each slab's contacts on identical inputs


def _sets(idx, mask, width):
    return {tuple(int(v) for v in row[:width]) for row, m in zip(np.asarray(idx),
                                                                np.asarray(mask)) if m > 0}


# The JAX package's detections as its domain tick runs them: jitted.
_jax_points, _jax_edges = (
    jax.jit(lambda *a, f=f: f(*a[:-1], emit_mask=a[-1]), static_argnums=(5,))
    for f in (jbroad.detect_point_tri_collisions, jbroad.detect_edge_edge_collisions))
_jax_nodes = jax.jit(lambda mask, radius, x, params, cfg, emit: jbroad.detect_node_node_pairs(
    SimpleNamespace(node_mask=mask, radius=radius), x, params, cfg, emit_mask=emit),
    static_argnums=(4,))


def _slab_sets(case, port: bool):
    """Each slab's contact set on the first substep's predicted views, by
    the port's twins or the JAX package's jitted detection."""
    jdom = case["jdom"]
    x, prev = case["views"]
    st = jdom.static
    out = []
    for s in range(jdom.meta.n_slabs):
        tri, tmask, emit = (np.asarray(a[s]) for a in (st.topo.triangles, st.topo.tri_mask,
                                                       st.tri_emit_mask))
        xs, ps = x[s], prev[s]
        if case["name"] == "node_line":
            own = np.zeros(jdom.meta.view, np.float32)
            own[jdom.meta.halo:jdom.meta.halo + jdom.meta.block] = 1.0
            node_emit = own * np.asarray(st.node_mask_view[s])
            if port:
                cfg = domain.domain_config(case["pcfg"])
                nn = broadphase.detect_node_node_pairs(
                    xs, torch.from_numpy(np.asarray(st.radius_view[s])),
                    torch.from_numpy(np.asarray(st.node_mask_view[s])), case["pparams"], cfg,
                    torch.zeros(2, dtype=torch.int32), True, torch.from_numpy(node_emit))
                n = min(int(nn.count[0]), cfg.budget.max_node_node_contacts)
                out.append({(int(a), int(b)) for a, b in zip(nn.pi[:n], nn.pj[:n])})
            else:
                idx, mask = _jax_nodes(jnp.asarray(st.node_mask_view[s]),
                                       jnp.asarray(st.radius_view[s]), jnp.asarray(xs.numpy()),
                                       case["params"], jax_domain_config(case["cfg"]),
                                       jnp.asarray(node_emit))
                out.append(_sets(idx, mask, 2))
            continue
        edges = case["name"] == "edge_strips"
        if port:
            cfg = domain.domain_config(case["pcfg"])
            args = (xs, ps, torch.from_numpy(tri), torch.from_numpy(tmask))
            if edges:
                over = torch.zeros(1, dtype=torch.int32)
                idx, mask, _, _ = broadphase.detect_edge_edge_collisions(
                    *args, case["pparams"], cfg, over, torch.zeros(2, dtype=torch.int32), True,
                    torch.from_numpy(emit))
            else:
                idx, mask, _, _, _ = broadphase.detect_point_tri_collisions(
                    xs, ps, torch.from_numpy(tmask), case["pparams"], cfg,
                    failed=torch.zeros(2, dtype=torch.int32), plain=True,
                    triangles=torch.from_numpy(tri), emit=torch.from_numpy(emit))
        else:
            fn = _jax_edges if edges else _jax_points
            idx, mask, _ = fn(jnp.asarray(xs.numpy()), jnp.asarray(ps.numpy()), jnp.asarray(tri),
                              jnp.asarray(tmask), case["params"], jax_domain_config(case["cfg"]),
                              jnp.asarray(emit))
        out.append(_sets(idx, mask, 4))
    return out


def _global(case, sets):
    """The slabs' sets in old node ids (a view slot s·L − B + v is new node
    s·L − B + v, whose old id is perm of it)."""
    meta, perm = case["jdom"].meta, np.asarray(case["jdom"].perm)
    out = []
    for s, contacts in enumerate(sets):
        base = s * meta.block - meta.halo
        out.append({tuple(int(perm[base + v]) for v in c) for c in contacts})
    return out


def _canon(name, c):
    """A contact up to the order its numbering gives it: a pair of nodes
    or of edges is unordered; a point-triangle contact keeps its order."""
    if name == "node_line":
        return frozenset(c)
    if name == "edge_strips":
        return frozenset((frozenset(c[:2]), frozenset(c[2:])))
    return c


def _single_set(case):
    """The single scene's contacts (the port's twins, old node ids) on the
    same predicted positions, under the domain's detection branch."""
    name, topo0 = case["name"], case["topo0"]
    jdom, st0 = case["jdom"], case["state0"]
    h = np.float32(case["pparams"].dt)
    st = jdom.state
    meta = jdom.meta
    mask = np.asarray(jdom.static.node_mask_view)[:, meta.halo:meta.halo + meta.block, None]
    x_new = (st.positions + h * st.velocities * mask).reshape(-1, 3)
    inv = np.asarray(jdom.inv_perm)
    x = torch.from_numpy(np.ascontiguousarray(x_new[inv]))
    prev = torch.from_numpy(np.ascontiguousarray(st.prev_positions.reshape(-1, 3)[inv]))
    cfg = domain.domain_config(case["pcfg"])
    failed = torch.zeros(2, dtype=torch.int32)
    if name == "node_line":
        nn = broadphase.detect_node_node_pairs(
            x, torch.from_numpy(np.asarray(st0.radius)), torch.from_numpy(np.asarray(
                st0.node_mask)), case["pparams"], cfg, failed, True)
        n = min(int(nn.count[0]), cfg.budget.max_node_node_contacts)
        found = {(int(a), int(b)) for a, b in zip(nn.pi[:n], nn.pj[:n])}
    else:
        tri = torch.from_numpy(np.array(topo0.triangles))
        tmask = torch.from_numpy(np.array(topo0.tri_mask))
        if name == "edge_strips":
            idx, mask, _, _ = broadphase.detect_edge_edge_collisions(
                x, prev, tri, tmask, case["pparams"], cfg, torch.zeros(1, dtype=torch.int32),
                failed, True)
        else:
            idx, mask, _, _, _ = broadphase.detect_point_tri_collisions(
                x, prev, tmask, case["pparams"], cfg, failed=failed, plain=True, triangles=tri)
        found = _sets(idx, mask, 4)
    return {_canon(name, c) for c in found}


def check_slab_sets(case):
    """Each slab's contacts by the port equal the JAX package's as sets;
    none is emitted twice, and together they are the single scene's."""
    port, ref = _slab_sets(case, True), _slab_sets(case, False)
    assert port == ref
    assert sum(len(s) for s in port) > 0, "no contact on the first substep"
    glob = [{_canon(case["name"], c) for c in s} for s in _global(case, port)]
    union = set().union(*glob)
    assert sum(len(s) for s in glob) == len(union)  # no contact emitted twice
    assert union == _single_set(case)


def check_single(name):
    """The port's domain against its own single scene from the same state
    over ``test_parallel.py``'s ticks and bounds (one tick 1e-5)."""
    _, _, ticks, atol, _, _, _ = SCENES[name]
    one, err, dfailed, sfailed = port_single(name, ticks)
    assert one < 1e-5, one
    assert err < atol, err
    assert not dfailed and not sfailed
