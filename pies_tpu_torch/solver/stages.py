"""One substep of the generic PD path with contacts (point-triangle,
edge-edge and node-node), or of the PBD solver, stage by stage, for holding
each kernel against its plain twin on the kernels' own inputs and for
timing each kernel on those inputs (``chip_smoke.py`` phases 16c, 17c and
18d, ``tests/test_torch_ensemble_contacts.py``,
``tests/test_torch_ensemble_edges.py`` and
``tests/test_torch_ensemble_pbd.py``)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..collision import broadphase
from ..collision.batches import CollisionSet, Incidence
from ..constraints import projections as proj
from ..state import clone_state, empty_node_pair_cache, stack_members
from . import assembly, pbd, pd, tetcols

# The stages of contact_stages whose outputs are written for a latched
# member too: the detections (an empty contact buffer, a fresh pair
# cache), the cache (left as it is) and the state; and of the CG, its
# residual partials and trips.
WHOLE_STAGES = ("detection", "edge detection", "T20", "cache", "T4")
# The stages of pbd_stages written for a latched member too: the head (its
# latch folded, nothing moved), the pair cache (left as it is) and the tail.
PBD_WHOLE = ("T18 head", "T20", "T18 tail")
# The stages whose kernel rounds apart from its twin: acosf against
# torch.acos in the bend rows (T18's, as T12's).
PBD_ROUNDOFF = ("T18 rows bend",)


class Stage(NamedTuple):
    """A stage's kernel outputs, its twin's on the same inputs (None when
    the twins were not run), and ``calls``: ``{name: (fn, args)}``, each
    kernel of the stage as ``fn(*args)`` on the batched inputs the kernel
    got (``state.member`` gives one member's), constants bound in ``fn``.
    A call may update its arguments in place."""

    kernel: tuple
    twin: tuple | None
    calls: dict


def _detection_calls(x, prev, cache, failed, topo, params, config) -> dict:
    """The detection's kernels as calls: T14 without and with a rebuild and
    T15 on the super-body layout (on copies of the updated cache), else
    T16 and T17 of the per-triangle branch (T17 on a T16 run's rows)."""
    ov = torch.zeros(x.shape[:-2] + (1,), dtype=torch.int32, device=x.device)
    mode = broadphase.tri_mode(config, topo.tri_mask.shape[0])
    if mode is None:
        corners, adj = topo.super_corners, topo.super_adj
        lay = broadphase.super_layout(config, corners, adj)
        sc = broadphase.scalars(params)
        if cache is None:
            cache = broadphase._fresh_cache(lay.k, lay.nb, x.shape[-2], x)

        def t14(x_, p_, c_, o_, f_):
            return broadphase.super_broadphase(x_, p_, corners, adj, c_, lay, sc, o_, f_)

        def t14_rebuild(x_, p_, c_, o_, f_):
            c_.fresh.zero_()
            return t14(x_, p_, c_, o_, f_)

        def t15(x_, p_, c_, o_, f_):
            return broadphase.super_narrowphase(x_, p_, corners, c_, lay, sc, o_, f_)

        return {"T14 without a rebuild": (t14, (x, prev, cache.clone(), ov, failed)),
                "T14 with a rebuild": (t14_rebuild, (x, prev, cache.clone(), ov, failed)),
                "T15": (t15, (x, prev, cache.clone(), ov, failed))}
    tris, tmask = topo.triangles, topo.tri_mask
    lay = broadphase.tri_layout(config, tris.shape[0], mode)
    sc = broadphase.tri_scalars(params, config)

    def t16(x_, p_, o_, f_):
        return broadphase.tri_candidates(x_, p_, tris, tmask, lay, sc, o_, f_)

    def t17(x_, p_, c_, k_, g_, f_):
        return broadphase.tri_ccd(x_, p_, tris, c_, k_, g_, lay, sc, f_)

    cand, count, flags = t16(x, prev, ov.clone(), failed)
    return {"T16 " + mode: (t16, (x, prev, ov, failed)),
            "T17": (t17, (x, prev, cand, count, flags, failed))}


def _twin(outs: list) -> tuple:
    """``(kernel, twin)`` of a stage's outputs (the twin None when it did
    not run)."""
    return outs[0], (outs[1] if len(outs) > 1 else None)


def _pair_nodes(nn, lim: torch.Tensor) -> torch.Tensor:
    """bool[..., N]: the nodes with a live pair (one below ``lim``) in a
    T20 cache, as the first node or as the second (whose list ascends)."""
    ro, ist, ip = nn.row_off.long(), nn.inc_start.long(), nn.inc_pair.long()
    lim = lim.long()
    as_i = torch.minimum(ro[..., 1:], lim) > ro[..., :-1]
    head = ip.gather(-1, ist[..., :-1].clamp_max(max(ip.shape[-1] - 1, 0)))
    return as_i | ((ist[..., 1:] > ist[..., :-1]) & (head < lim))


def contact_stages(states, topo, params, config, twins: bool = True) -> dict:
    """One substep of the generic PD path with contacts on a copy of
    ``states`` (a single scene or an ensemble), stage by stage by the
    kernels, and (``twins``) each stage's plain twin on the same inputs
    (the kernels' outputs carried forward): ``{stage: Stage}`` for T3, T24
    (on the entry-list floor); with point-triangle self-contact the
    detection (T14/T15 or T16/T17) and the cache it updates, T7's setup
    and (recentered coupling) its force; with edge-edge contacts the edge
    detection (T16 in its cell-list mode, T25) and T26's setup; with
    node-node contacts T20's pair prefix and T27's setup; then T9's stage 2
    with every contact term (T23's stacked force under full coupling,
    T26's and T27's terms), T10 (T23's and T26's blocks), T11, T8 (the
    stabilization with T26's edge pass, and the point-triangle friction),
    T27's friction, with node-node contacts T8's friction with its impulse,
    and T4.  Values a kernel leaves unwritten for a member without
    contacts or at a node without contact entries are zeroed in both, so
    the two compare bit for bit (:func:`stages_apart`)."""

    def pair(kernel, twin, *args, **kw):
        return kernel(*args, **kw), (twin(*args, **kw) if twins else None)

    st = clone_state(states)
    out = {}
    head = pd.substep_head(st, topo, params, config, True)
    out["T3"] = Stage(head, pd.substep_head_plain(clone_state(states), topo, params, config,
                                                  True) if twins else None, {})
    x, msn, diag, wf, active = head
    failed, prev = st.sim_failed, st.prev_positions
    lead = x.shape[:-2]
    _, h2 = pd._h_h2(params)
    floor = None
    if not config.dense_floor:
        dk, dp = diag.clone(), diag.clone()
        d24 = diag.clone()
        wf, floor = pd.floor_entries(x, topo, params, config, dk, failed)
        twin = None
        if twins:
            wfp, fp = pd.floor_entries_plain(x, topo, params, config, dp, failed)
            twin = (dp, wfp, fp.floor_active, fp.floor_counts, fp.static_mask)

        def t24(x_, d_, f_):
            return pd.floor_entries(x_, topo, params, config, d_, f_)

        out["T24"] = Stage((dk, wf, floor.floor_active, floor.floor_counts, floor.static_mask),
                           twin, {"T24": (t24, (x, d24, failed))})
        diag, active = dk, floor.floor_active
    full_c = config.contact_coupling == "full"
    pt_on, edge_on = pd.self_contact(config, topo), pd.edge_contact(config, topo)
    node_on = config.enable_node_collisions
    # The operator's dense diagonal, as the substep forms it.
    sd_on = node_on or (not full_c and (pt_on or edge_on))
    sd = wf.clone() if sd_on else wf
    thick = params.collision_thickness
    colls = CollisionSet(floor_active=active,
                         overflow=torch.zeros(lead + (1,), dtype=torch.int32, device=x.device))
    inc = ptd = pt_count = full = pt = edges = nodes = None
    none = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    on = none[..., None]  # nodes with point-triangle entries
    if pt_on:
        caches = [clone_state(st.bp) if st.bp is not None else None for _ in range(2)]
        det = [broadphase.detect_point_tri_collisions(
            x, prev, topo.tri_mask, params, config, cache=c, failed=failed, plain=plain,
            corners=topo.super_corners, adj=topo.super_adj, triangles=topo.triangles)
            for c, plain in zip(caches, (False, True)[: 1 + twins])]
        out["detection"] = Stage(det[0], det[1] if twins else None, _detection_calls(
            x, prev, caches[0], failed, topo, params, config))
        if st.bp is not None:
            cache = [(c.pairs, c.valid, c.ref, c.fresh) for c in caches]
            out["cache"] = Stage(cache[0], cache[1] if twins else None, {})
        pt_idx, pt_mask, pt_count, overflow, rebuilt = det[0]
        colls = CollisionSet(floor_active=active, pt_idx=pt_idx, pt_mask=pt_mask,
                             pt_count=pt_count, overflow=overflow, rebuilt=rebuilt)
        live = pt_count > 0
        setups, incs = [], []
        for setup in (tetcols.pt_coupling_setup, tetcols.pt_coupling_setup_plain)[: 1 + twins]:
            d, s_ = diag.clone(), sd.clone()
            inc, ptd = setup(colls, st.mass, topo, h2, d, wf, failed,
                             None if full_c else s_)
            o = (inc.row_start[..., 1:] > inc.row_start[..., :-1]) & live
            setups.append((torch.where(live, inc.row_start, 0), torch.where(o, ptd, 0.0), d, s_))
            incs.append(inc)

        def t7_setup(c_, ms_, d_, w_, f_, s_):
            return tetcols.pt_coupling_setup(c_, ms_, topo, h2, d_, w_, f_, s_)

        out["T7 setup"] = Stage(setups[0], setups[1] if twins else None, {"T7 setup": (
            t7_setup, (colls, st.mass, diag.clone(), wf, failed,
                       None if full_c else wf.clone()))})
        # (a member without contacts gets an empty incidence: the kernel
        # leaves its rows unwritten)
        row_start, ptd, diag, s_ = setups[0]
        sd = s_ if sd_on else wf
        inc = dataclasses.replace(incs[0], row_start=row_start)
        on = (row_start[..., 1:] > row_start[..., :-1])[..., None]
        if full_c:
            full = assembly.FullCoupling(colls, inc, thick)
        else:
            contact = pair(tetcols.pt_force, tetcols.pt_force_plain, x, colls, inc, thick,
                           failed)

            def t7_force(x_, c_, i_, f_):
                return tetcols.pt_force(x_, c_, i_, thick, f_)

            out["T7 force"] = Stage((torch.where(on, contact[0], 0.0),),
                                    (torch.where(on, contact[1], 0.0),) if twins else None,
                                    {"T7 force": (t7_force, (x, colls, inc, failed))})
            pt = (ptd, contact[0], row_start, pt_count)
    if edge_on:
        lay = broadphase.tri_layout(config, topo.triangles.shape[0], "celllist")
        sc = broadphase.scalars(params)
        found = [broadphase.detect_edge_edge_collisions(
            x, prev, topo.triangles, topo.tri_mask, params, config, o, failed, plain) + (o,)
            for o, plain in zip((colls.overflow.clone(), colls.overflow.clone()),
                                (False, True)[: 1 + twins])]

        def t16e(x_, p_, o_, f_):
            return broadphase.tri_candidates(x_, p_, topo.triangles, topo.tri_mask, lay, sc, o_,
                                             f_)

        def t25(x_, p_, c_, k_, g_, f_):
            return broadphase.edge_ccd(x_, p_, topo.triangles, c_, k_, g_,
                                       config.budget.max_edge_contacts,
                                       config.reference_quirks, f_)

        cand, count, flags = t16e(x, prev, colls.overflow.clone(), failed)
        out["edge detection"] = Stage(found[0], found[1] if twins else None, {
            "T16 edges": (t16e, (x, prev, colls.overflow.clone(), failed)),
            "T25": (t25, (x, prev, cand, count, flags, failed))})
        (colls.edge_idx, colls.edge_mask, colls.edge_count, colls.edge_hits,
         colls.overflow) = found[0]
    if node_on:
        def t20(x_, r_, m_, f_):
            return broadphase.detect_node_node_pairs(x_, r_, m_, params, config, f_)

        nns = [broadphase.detect_node_node_pairs(x, st.radius, st.node_mask, params, config,
                                                 failed, plain)
               for plain in (False, True)[: 1 + twins]]
        out["T20"] = Stage(*_twin([tuple(getattr(c, f.name) for f in dataclasses.fields(c))
                                   for c in nns]),
                           {"T20": (t20, (x, st.radius, st.node_mask, failed))})
        colls.nn, colls.nn_cap = nns[0], config.budget.max_node_node_contacts
        setups = []
        for setup in (assembly.node_setup, assembly.node_setup_plain)[: 1 + twins]:
            d, s_ = diag.clone(), sd.clone()
            t = setup(colls.nn, colls.nn_cap, st.mass, st.radius, st.inv_mass, topo, h2, d, wf,
                      failed, s_, inc, ptd, not full_c, pt_count)
            o = _pair_nodes(colls.nn, t.lim)
            setups.append((t, d, s_, o))
        def t27(n_, ms_, d_, w_, f_, s_, i_, q_, k_):
            return assembly.node_setup(n_, colls.nn_cap, ms_, st.radius, st.inv_mass, topo, h2,
                                       d_, w_, f_, s_, i_, q_, not full_c, k_)

        out["T27 setup"] = Stage(*_twin([(t.lim, torch.where(o, t.nnd, 0.0), d, s_)
                                         for t, d, s_, o in setups]),
                                 {"T27 setup": (t27, (colls.nn, st.mass, diag.clone(), wf,
                                                      failed, sd.clone(), inc, ptd, pt_count))})
        nodes, diag, sd, o = setups[0]
        nodes = dataclasses.replace(nodes, nnd=torch.where(o, nodes.nnd, 0.0))
    if edge_on:
        setups = []
        for setup in (assembly.edge_setup, assembly.edge_setup_plain)[: 1 + twins]:
            d, s_ = diag.clone(), sd.clone()
            e = setup(colls, st.mass, st.inv_mass, topo, h2, d, wf, thick,
                      config.reference_quirks, full_c, failed, s_ if sd_on else None, inc, ptd,
                      nodes, pt_count)
            total = e.inc.row_start[..., -1:]
            slot = torch.arange(e.inc.entries.shape[-1], device=x.device) < total
            o = e.inc.row_start[..., 1:] > e.inc.row_start[..., :-1]
            e = dataclasses.replace(e, ed=torch.where(o, e.ed, 0.0), inc=Incidence(
                e.inc.row_start, torch.where(slot, e.inc.entries, 0),
                torch.where(slot, e.inc.nodes, 0), e.inc.cap))
            setups.append((e, d, s_))

        def t26(c_, ms_, d_, w_, f_, s_, i_, q_, n_, k_):
            return assembly.edge_setup(c_, ms_, st.inv_mass, topo, h2, d_, w_, thick,
                                       config.reference_quirks, full_c, f_, s_, i_, q_, n_, k_)

        out["T26 setup"] = Stage(*_twin([(e.inc.row_start, e.inc.entries, e.inc.nodes, e.ed,
                                          d, s_) for e, d, s_ in setups]),
                                 {"T26 setup": (t26, (colls, st.mass, diag.clone(), wf, failed,
                                                      sd.clone() if sd_on else None, inc, ptd,
                                                      nodes, pt_count))})
        edges, diag, s_ = setups[0]
        sd = s_ if sd_on else wf
    rows = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats.clone(), topo,
                               config.rotation_iterations, failed)
    plane = pd.floor_plane(params, config.reference_quirks)

    def t9(x_, m_, w_, r_, f_, p_, u_, l_, e_, n_):
        return assembly.assemble_force(x_, m_, w_, r_, topo, plane, f_, p_, u_, l_, e_, n_)

    force = pair(assembly.assemble_force, assembly.assemble_force_plain, x, msn, wf, rows, topo,
                 plane, failed, pt, full, floor, edges, nodes)
    out["T9 stage 2"] = Stage(*force, {"T9 stage 2": (
        t9, (x, msn, wf, rows, failed, pt, full, floor, edges, nodes))})
    force, static = force[0]

    def t10(x_, ms_, s_, f_, u_, e_):
        return assembly.apply_system(x_, ms_, s_, h2, topo, f_, part=True, full=u_, edges=e_)

    out["T10"] = Stage(
        assembly.apply_system(x, st.mass, sd, h2, topo, failed, part=True, full=full,
                              edges=edges),
        assembly.apply_system_plain(x, st.mass, sd, h2, topo, part=True, full=full,
                                    edges=edges) if twins else None,
        {"T10": (t10, (x, st.mass, sd, failed, full, edges))})
    block = (assembly.tet_block_factor(diag, topo.tet_block6, failed)
             if pd.block_layout(st, topo) else None)
    sol = pair(assembly.pcg_solve, assembly.pcg_solve_plain, force, x, diag, st.mass, sd, h2,
               st.node_mask, topo, config.cg_iterations, config.cg_rtol, failed, block, full,
               edges)
    out["T11"] = Stage(*sol, {})
    x8, s8 = sol[0][0], st
    fric = nn_imp = None
    stages8 = pd.STABILIZE if node_on else pd.STABILIZE | pd.FRICTION
    if pt_on or edge_on:
        tails = []
        for tail in (pd.pt_tail, pd.pt_tail_plain)[: 1 + twins]:
            s_, x_ = clone_state(st), x8.clone()
            f_ = tail(s_, params, config, colls, inc, x_, static, edges, None, stages8)
            if not stages8 & pd.FRICTION:  # (no friction stage: the impulse is unwritten)
                f_ = torch.zeros_like(f_)
            tails.append((x_, s_.prev_positions, torch.where(on, f_, 0.0)))

        def t8(s_, c_, i_, x_, t_, e_):
            return pd.pt_tail(s_, params, config, c_, i_, x_, t_, e_, None, stages8)

        out["T8"] = Stage(tails[0], tails[1] if twins else None, {"T8": (
            t8, (clone_state(st), colls, inc, x8.clone(), static, edges))})
        x8, s8 = tails[0][0], clone_state(st)
        s8.prev_positions.copy_(tails[0][1])
        fric = tails[0][2]
    if node_on:
        imp = pair(pd.node_friction, pd.node_friction_plain, x8, s8, params, nodes, failed)

        def t27f(x_, s_, n_, f_):
            return pd.node_friction(x_, s_, params, n_, f_)

        out["T27 friction"] = Stage(*imp, {"T27 friction": (t27f, (x8, s8, nodes, failed))})
        nn_imp = imp[0][0]
        if pt_on:
            tails = []
            for tail in (pd.pt_tail, pd.pt_tail_plain)[: 1 + twins]:
                s_, x_ = clone_state(s8), x8.clone()
                f_ = tail(s_, params, config, colls, inc, x_, static, None, nn_imp, pd.FRICTION)
                tails.append((torch.where(on, f_, 0.0),))
            out["T8 friction"] = Stage(tails[0], tails[1] if twins else None, {})
            fric = tails[0][0]
    counts = None if floor is None else floor.floor_counts
    ends = []
    for tail in (pd.substep_tail, pd.substep_tail_plain)[: 1 + twins]:
        s4 = clone_state(s8)
        tail(s4, topo, params, active, x8, static, colls, inc, fric, counts, nn_imp)
        ends.append((s4.positions, s4.prev_positions, s4.velocities, s4.forces, s4.sim_failed))

    def t4(s_, a_, x_, t_, c_, i_, r_, k_, n_):
        return pd.substep_tail(s_, topo, params, a_, x_, t_, c_, i_, r_, k_, n_)

    out["T4"] = Stage(ends[0], ends[1] if twins else None, {"T4": (
        t4, (clone_state(s8), active, x8.clone(), static, colls, inc, fric, counts, nn_imp))})
    return out


def stages_apart(stages: dict, live=None, whole=WHOLE_STAGES, roundoff=()) -> list:
    """The stages of a :func:`contact_stages` (or :func:`pbd_stages`, with
    ``whole=PBD_WHOLE`` and ``roundoff=PBD_ROUNDOFF``) run whose kernel and
    twin outputs differ: bit for bit, or for the ``roundoff`` stages by more
    than 1e-6 of the largest value (at least 1).  ``live`` (the unlatched
    members of an ensemble) limits the stages a latched member leaves
    unwritten to those members."""
    apart = []
    for stage, (kernel, twin, _) in stages.items():
        for i, (a, b) in enumerate(zip(kernel, twin)):
            if live is not None and not (stage in whole or (stage == "T11" and i > 0)):
                a, b = a[live], b[live]
            if stage in roundoff:
                ok = float((a - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1.0)
            else:
                ok = torch.equal(a, b)
            if not ok:
                apart.append(f"{stage}[{i}]")
    return apart


def _cache_prefix(nn) -> tuple:
    """A node-pair cache's fields with the pair slots past each member's
    count zeroed (no kernel writes them)."""
    slot = torch.arange(nn.pi.shape[-1], device=nn.pi.device) < nn.count
    cut = lambda t: torch.where(slot, t, 0)  # noqa: E731
    return (cut(nn.pi), cut(nn.pj), nn.count, nn.ref, nn.fresh, nn.row_off, nn.inc_start,
            cut(nn.inc_pair), nn.rebuilt)


def pbd_stages(states, topo, params, config, twins: bool = True) -> dict:
    """One PBD substep on a copy of ``states`` (a single scene or an
    ensemble; the first substep of a tick, one iteration), stage by stage
    by the kernels, and (``twins``) each stage's plain twin on the same
    inputs (the kernels' outputs carried forward): ``{stage: Stage}`` for
    T18's head, each family present its rows and application (the pins,
    the Jacobi distance form, strain, bend), T19's chain walk or colour
    classes, with collisions on T20 (the state's pair cache, or an empty
    one per member; its calls without and with a rebuild) and T21, T18's
    floor clamp and its tail."""

    def pair(kernel, twin, *args, **kw):
        return kernel(*args, **kw), (twin(*args, **kw) if twins else None)

    def inplace(stage, kernel, twin, x, *args):
        """An in-place stage ``kernel(x, *args)`` (the topology bound in
        ``kernel`` and ``twin``, ``args`` batched): the kernel's output and
        the twin's, each on a copy; returns the kernel's."""
        xk = x.clone()
        kernel(xk, *args)
        xp = None
        if twins:
            xp = x.clone()
            twin(xp, *args)
        out[stage] = Stage((xk,), (xp,) if twins else None, {stage: (kernel, (x.clone(),) + args)})
        return xk

    out = {}
    st = clone_state(states)
    pbd.substep_head(st, params, True)
    tw = None
    if twins:
        tw = clone_state(states)
        pbd.substep_head_plain(tw, params, True)
    fields = lambda s_: (s_.positions, s_.prev_positions, s_.sim_failed)  # noqa: E731
    out["T18 head"] = Stage(fields(st), fields(tw) if twins else None, {"T18 head": (
        lambda s_: pbd.substep_head(s_, params, True), (clone_state(states),))})
    x, failed, im = st.positions, st.sim_failed, st.inv_mass
    inc = topo.jacobi

    def family(kind, batch, incidence, **kw):
        nonlocal x
        if not batch.idx.shape[0]:
            return

        def rows(x_, m_, f_):  # (the batch is the topology's: bound, not batched)
            return proj.jacobi_rows(kind, x_, m_, batch, failed=f_, **kw)

        vals = pair(proj.jacobi_rows, proj.jacobi_rows_plain, kind, x, im, batch, failed=failed,
                    **kw)
        out[f"T18 rows {kind}"] = Stage((vals[0],), (vals[1],) if twins else None,
                                        {f"T18 rows {kind}": (rows, (x, im, failed))})
        x = inplace(f"T18 apply {kind}",
                    lambda x_, v_, f_: pbd.apply_jacobi(x_, incidence, v_, f_),
                    lambda x_, v_, f_: pbd.apply_jacobi_plain(x_, incidence, v_, f_), x,
                    vals[0], failed)

    family("position", topo.position, inc.position, w_scale=pbd._keep(params.release_hinge))
    ch, dist, ends = topo.chains, topo.distance, config.distance_colors
    if config.distance_chain and ch is not None:
        x = inplace("T19 chains", lambda x_, f_: pbd.chain_scan(x_, ch, f_),
                    lambda x_, f_: pbd.chain_scan_plain(x_, ch, f_), x, failed)
    elif ends:
        x = inplace("T19 colours", lambda x_, f_: pbd.color_classes(x_, dist, ends, f_),
                    lambda x_, f_: pbd.color_classes_plain(x_, dist, ends, f_), x, failed)
    else:
        family("distance", topo.distance, inc.distance)
    family("strain", topo.strain, inc.strain, recenter=not config.reference_quirks)
    family("bend", topo.bend, inc.bend)
    vel = st.velocities
    if config.enable_collisions:
        cache = st.nn
        if cache is None:
            cache = empty_node_pair_cache(x.shape[-2], config.budget.max_candidates_per_node,
                                          x.device)
            if st.members:
                cache = stack_members([cache] * st.members)
        args = (st.radius, st.node_mask)
        caches = [cache.clone() for _ in range(1 + twins)]
        for c_, fn in zip(caches, (broadphase.node_pairs, broadphase.node_pairs_plain)):
            fn(x, *args, c_, params, config, failed)

        def t20(x_, r_, m_, c_, f_):
            return broadphase.node_pairs(x_, r_, m_, c_, params, config, f_)

        def t20_rebuild(x_, r_, m_, c_, f_):
            c_.fresh.zero_()
            return t20(x_, r_, m_, c_, f_)

        out["T20"] = Stage(_cache_prefix(caches[0]), _cache_prefix(caches[1]) if twins else None,
                           {"T20 without a rebuild": (t20, (x, *args, caches[0].clone(), failed)),
                            "T20 with a rebuild": (t20_rebuild,
                                                   (x, *args, caches[0].clone(), failed))})
        nn = caches[0]
        resp = pair(broadphase.node_response, broadphase.node_response_plain, x, vel, st.radius,
                    im, st.node_mask, nn, params, failed)

        def t21(x_, v_, r_, i_, m_, n_, f_):
            return broadphase.node_response(x_, v_, r_, i_, m_, n_, params, f_)

        out["T21"] = Stage(*resp, {"T21": (t21, (x, vel, st.radius, im, st.node_mask, nn,
                                                 failed))})
        x, vel = resp[0][0], resp[0][1]
    fh = params.floor_height
    x = inplace("T18 floor", lambda x_, r_, m_, f_: pbd.floor_clamp(x_, r_, m_, fh, f_),
                lambda x_, r_, m_, f_: pbd.floor_clamp_plain(x_, r_, m_, fh, f_), x, st.radius,
                st.node_mask, failed)
    ends = []
    for tail in (pbd.substep_tail, pbd.substep_tail_plain)[: 1 + twins]:
        s_ = clone_state(st)
        tail(s_, x, params)
        ends.append((s_.positions, s_.prev_positions, s_.velocities, s_.sim_failed))
    out["T18 tail"] = Stage(ends[0], ends[1] if twins else None, {"T18 tail": (
        lambda s_, x_: pbd.substep_tail(s_, x_, params), (clone_state(st), x.clone()))})
    return out
