"""``chip_smoke.py``'s phase 21 under NCCL, one rank a card, on four cards.

Phase 21 runs its four ranks on one card over gloo (NCCL refuses two ranks
on one device), so every collective there is a host round trip.  This
script builds the same inputs without the phases before it and runs the
same ranks under NCCL, rank r on ``cuda:r``:

* 21a: 64 soups of 512 tets with self-contact (phase 13's ensemble) after
  75 ticks, 16 members a rank;
* 21b: the 110,592-node mesh (phase 5's, ``scripts/refbench/
  tet_cube_mesh_100k.txt``) at tick 75 in 8 slabs, and the 500,000-node
  soup with self-contact (phase 3b's) at tick 45 in 4, each beside its
  one-card domain (phase 20's tick and ms/tick) and the single scene's
  tick and one-ulp spread, the bound phase 20 holds.

Run on a machine with four cards: ``python3 scripts/ranks_nccl.py``.  It
prints phase 21's checks and numbers; it exits non-zero if one fails.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402


def reference(pt, label, state, topo, params, cfg, slabs, margin, n_live, dev):
    """Phase 20's figures for one scene: its one-card domain, the single
    scene's generic tick and the bound (1e-5, or twice the tick's one-ulp
    spread), the one-card domain's ms/tick over 10 ticks."""
    import torch

    from pies_tpu_torch.parallel import domain
    from pies_tpu_torch.solver import step

    dom = domain.partition_domain(cs.clone_state(state), topo, slabs, collision_margin=margin)
    gcfg = dataclasses.replace(domain.domain_config(cfg), tet_cols=False)
    gtopo = dataclasses.replace(topo, tet_block6=None)
    single = cs.clone_state(state)
    step.tick(single, gtopo, params, gcfg)
    gen = torch.Generator(device=dev).manual_seed(20)
    u = cs.clone_state(state)
    moved = (torch.rand(u.positions.shape, generator=gen, device=dev) < 0.5) \
        & (u.node_mask[:, None] > 0)
    up = torch.rand(u.positions.shape, generator=gen, device=dev) < 0.5
    u.positions.copy_(torch.where(moved, torch.nextafter(
        u.positions, torch.where(up, float("inf"), float("-inf"))), u.positions))
    step.tick(u, gtopo, params, gcfg)
    spread = float((u.positions[:n_live] - single.positions[:n_live]).abs().max())
    tick = domain.make_domain_tick(cfg, dom.meta)
    run = domain.partition_domain(cs.clone_state(state), topo, slabs, collision_margin=margin)
    tick(run.state, run.static, params)
    one_card = torch.from_numpy(domain.gather_positions(run, run.state)[:n_live])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        tick(run.state, run.static, params)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 100
    print(f"{label}: {slabs} slabs, one-card domain {ms:.3f} ms/tick, the single scene's one-ulp"
          f" spread {spread:.3e}")
    return dict(dom=dom, state=state, topo=topo, params=params, config=cfg, n_live=n_live,
                margin=margin, tol=max(1e-5, 2.0 * spread), ms=ms,
                single=single.positions[:n_live].cpu(), one_card=one_card)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cs.R21:
        print(f"this script needs {cs.R21} CUDA devices", file=sys.stderr)
        return 2
    import pies_tpu_torch as pt
    from pies_tpu_torch import kernels
    from pies_tpu_torch.parallel import ensemble
    from pies_tpu_torch.state import stack_ensemble

    smi = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"nvidia-smi: {smi}")
    t_all = time.perf_counter()
    kernels.lib()
    dev = torch.device("cuda", 0)
    PD = pt.SolverName.PD
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, device=dev)
    s.create_tet_soup(cs.ENS_TETS, **cs.SCENE)
    s._prepare()
    states = stack_ensemble(s.state, cs.ENS_MEMBERS)
    live = s._builder.num_nodes
    gen = torch.Generator(device=dev).manual_seed(13)
    off = (torch.rand((cs.ENS_MEMBERS, live, 3), generator=gen, device=dev) - 0.5) * 0.04
    states.positions[:, :live] += off
    states.prev_positions[:, :live] += off
    ensemble.ensemble_tick_n(states, s.topology, s.current_params(), s.config,
                             cs.CONTACT_WARMUP + 30)
    ens13 = (states, s.topology, s.current_params(), s.config)
    keep21 = {}
    m = cs.mesh_solver(pt, cs.MESH_BIG, dev)
    m._prepare()
    m.run_ticks(cs.MESH_WARMUP)
    keep21["20a"] = reference(pt, "20a", cs.clone_state(m.state), m.topology, m.current_params(),
                              m.config, 8, 0.0, m._builder.num_nodes, dev)
    del m
    p = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, device=dev)
    p.create_tet_soup(cs.N_TETS, **cs.SCENE)
    p._prepare()
    p.run_ticks(cs.CONTACT_WARMUP)
    cfg = dataclasses.replace(p.config, budget=dataclasses.replace(p.config.budget,
                                                                   max_narrow_candidates=32))
    topo, params = p.topology, p.current_params()
    tris = p.state.positions[topo.triangles[topo.tri_mask > 0].long()]
    margin = params.collision_threshold_distance + 2.0 * float(
        (tris.amax(1) - tris.amin(1)).max())
    keep21["20b"] = reference(pt, "20b", cs.clone_state(p.state), topo, params, cfg, 4, margin,
                              int((p.state.node_mask > 0).sum()), dev)
    del p
    rows = {}

    def row(name, source, replaces, err, ms, plain_ms, tol_text, nbytes, ops, library_ms=None):
        b_ms, b_by = cs.bound(nbytes, ops)
        print(f"  {name}: max err {err:.3e} ({tol_text}); kernel {ms:.4f} ms, plain"
              f" {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows[name] = dict(name=name)

    print(f"(inputs built in {time.perf_counter() - t_all:.1f} s)")
    cs.phase21(pt, dev, smi, row, rows, ens13, keep21, backend="nccl")
    print(f"(all: {time.perf_counter() - t_all:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
