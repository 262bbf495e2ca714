"""One substep of the generic PD path with point-triangle contacts, stage by
stage, for holding each kernel against its plain twin on the kernels' own
inputs and for timing each kernel on those inputs (``chip_smoke.py`` phase
16c and ``tests/test_torch_ensemble_contacts.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..collision import broadphase
from ..collision.batches import CollisionSet, Incidence
from ..state import clone_state
from . import assembly, pd, tetcols

# The stages of contact_stages whose outputs are written for a latched
# member too: the detection (an empty contact buffer), the cache (left as
# it is) and the state; and of the CG, its residual partials and trips.
WHOLE_STAGES = ("detection", "cache", "T4")


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


def contact_stages(states, topo, params, config, twins: bool = True) -> dict:
    """One substep of the generic PD path with point-triangle contacts on a
    copy of ``states`` (a single scene or an ensemble), stage by stage by
    the kernels, and (``twins``) each stage's plain twin on the same
    inputs (the kernels' outputs carried forward): ``{stage: Stage}`` for
    T3, T24 (on the entry-list floor), the detection (T14/T15 or T16/T17)
    and the cache it updates, T7's setup and (recentered coupling) its
    force, T9's stage 2 with the contact terms (T23's stacked force under
    full coupling), T10 (T23's blocks), T11, T8 and T4.  Values a kernel
    leaves unwritten for a member without contacts or at a node without
    contact entries are zeroed in both, so the two compare bit for bit
    (:func:`stages_apart`)."""

    def pair(kernel, twin, *args, **kw):
        return kernel(*args, **kw), (twin(*args, **kw) if twins else None)

    st = clone_state(states)
    out = {}
    head = pd.substep_head(st, topo, params, config, True)
    out["T3"] = Stage(head, pd.substep_head_plain(clone_state(states), topo, params, config,
                                                  True) if twins else None, {})
    x, msn, diag, wf, active = head
    failed, prev = st.sim_failed, st.prev_positions
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
    full_c = config.contact_coupling == "full"
    live = pt_count > 0
    setups, incs = [], []
    for setup in (tetcols.pt_coupling_setup, tetcols.pt_coupling_setup_plain)[: 1 + twins]:
        d, sd = diag.clone(), wf.clone()
        inc, ptd = setup(colls, st.mass, topo, h2, d, wf, failed, None if full_c else sd)
        on = (inc.row_start[..., 1:] > inc.row_start[..., :-1]) & live
        setups.append((torch.where(live, inc.row_start, 0), torch.where(on, ptd, 0.0), d, sd))
        incs.append(inc)

    def t7_setup(c_, ms_, d_, w_, f_, s_):
        return tetcols.pt_coupling_setup(c_, ms_, topo, h2, d_, w_, f_, s_)

    out["T7 setup"] = Stage(setups[0], setups[1] if twins else None, {"T7 setup": (
        t7_setup, (colls, st.mass, diag.clone(), wf, failed, None if full_c else wf.clone()))})
    # (a member without contacts gets an empty incidence: the kernel leaves
    # its rows unwritten)
    row_start, ptd, diag, sd = setups[0]
    inc = Incidence(row_start, incs[0].entries, incs[0].nodes, incs[0].cap)
    on = (row_start[..., 1:] > row_start[..., :-1])[..., None]
    thick = params.collision_thickness
    full = pt = None
    if full_c:
        sd = wf
        full = assembly.FullCoupling(colls, inc, thick)
    else:
        contact = pair(tetcols.pt_force, tetcols.pt_force_plain, x, colls, inc, thick, failed)

        def t7_force(x_, c_, i_, f_):
            return tetcols.pt_force(x_, c_, i_, thick, f_)

        out["T7 force"] = Stage((torch.where(on, contact[0], 0.0),),
                                (torch.where(on, contact[1], 0.0),) if twins else None,
                                {"T7 force": (t7_force, (x, colls, inc, failed))})
        pt = (ptd, contact[0], row_start, pt_count)
    rows = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats.clone(), topo,
                               config.rotation_iterations, failed)
    plane = pd.floor_plane(params, config.reference_quirks)

    def t9(x_, m_, w_, r_, f_, p_, u_, l_):
        return assembly.assemble_force(x_, m_, w_, r_, topo, plane, f_, p_, u_, l_)

    force = pair(assembly.assemble_force, assembly.assemble_force_plain, x, msn, wf, rows, topo,
                 plane, failed, pt, full, floor)
    out["T9 stage 2"] = Stage(*force, {"T9 stage 2": (
        t9, (x, msn, wf, rows, failed, pt, full, floor))})
    force, static = force[0]

    def t10(x_, ms_, s_, f_, u_):
        return assembly.apply_system(x_, ms_, s_, h2, topo, f_, part=True, full=u_)

    out["T10"] = Stage(
        assembly.apply_system(x, st.mass, sd, h2, topo, failed, part=True, full=full),
        assembly.apply_system_plain(x, st.mass, sd, h2, topo, part=True, full=full)
        if twins else None, {"T10": (t10, (x, st.mass, sd, failed, full))})
    block = (assembly.tet_block_factor(diag, topo.tet_block6, failed)
             if pd.block_layout(st, topo) else None)
    sol = pair(assembly.pcg_solve, assembly.pcg_solve_plain, force, x, diag, st.mass, sd, h2,
               st.node_mask, topo, config.cg_iterations, config.cg_rtol, failed, block, full)
    out["T11"] = Stage(*sol, {})
    x_new = sol[0][0]
    tails = []
    for tail in (pd.pt_tail, pd.pt_tail_plain)[: 1 + twins]:
        s8, x8 = clone_state(st), x_new.clone()
        fric = tail(s8, params, config, colls, inc, x8, static)
        tails.append((x8, s8.prev_positions, torch.where(on, fric, 0.0)))

    def t8(s_, c_, i_, x_, t_):
        return pd.pt_tail(s_, params, config, c_, i_, x_, t_)

    out["T8"] = Stage(tails[0], tails[1] if twins else None, {"T8": (
        t8, (clone_state(st), colls, inc, x_new.clone(), static))})
    x8, _, fric = tails[0]
    counts = None if floor is None else floor.floor_counts
    ends = []
    for tail in (pd.substep_tail, pd.substep_tail_plain)[: 1 + twins]:
        s4 = clone_state(st)
        s4.prev_positions.copy_(tails[0][1])
        tail(s4, topo, params, active, x8, static, colls, inc, fric, counts)
        ends.append((s4.positions, s4.prev_positions, s4.velocities, s4.forces, s4.sim_failed))

    def t4(s_, a_, x_, t_, c_, i_, r_, k_):
        return pd.substep_tail(s_, topo, params, a_, x_, t_, c_, i_, r_, k_)

    out["T4"] = Stage(ends[0], ends[1] if twins else None, {"T4": (
        t4, (clone_state(st), active, x8.clone(), static, colls, inc, fric, counts))})
    return out


def stages_apart(stages: dict, live=None) -> list:
    """The stages of a :func:`contact_stages` run whose kernel and twin
    outputs differ (bit for bit).  ``live`` (the unlatched members of an
    ensemble) limits the stages a latched member leaves unwritten to those
    members."""
    apart = []
    for stage, (kernel, twin, _) in stages.items():
        for i, (a, b) in enumerate(zip(kernel, twin)):
            if live is not None and not (stage in WHOLE_STAGES or (stage == "T11" and i > 0)):
                a, b = a[live], b[live]
            if not torch.equal(a, b):
                apart.append(f"{stage}[{i}]")
    return apart
