"""Where a tick of the PyTorch + CUDA port spends its time, on one GPU.

    python3 -m pies_tpu_torch.tick_profile [n_tets] [repeats] [--collisions]
    python3 -m pies_tpu_torch.tick_profile --mesh [repeats]
    python3 -m pies_tpu_torch.tick_profile --cloth [repeats]
    python3 -m pies_tpu_torch.tick_profile --mixed [repeats]
    python3 -m pies_tpu_torch.tick_profile --boxes [repeats] [--reference]
    python3 -m pies_tpu_torch.tick_profile --rope [particles] [repeats]
    python3 -m pies_tpu_torch.tick_profile --pile [particles] [repeats]
    python3 -m pies_tpu_torch.tick_profile --nets [nn] [repeats]
    python3 -m pies_tpu_torch.tick_profile --node-cloud [particles] [repeats]
    python3 -m pies_tpu_torch.tick_profile --ensemble [members] [repeats]
    python3 -m pies_tpu_torch.tick_profile --ensemble-generic [members] [repeats]
    python3 -m pies_tpu_torch.tick_profile --ensemble-contacts [members] [repeats] [--boxes]
    python3 -m pies_tpu_torch.tick_profile --ensemble-edges [members] [repeats] [--cloud]
    python3 -m pies_tpu_torch.tick_profile --ensemble-pbd [members] [repeats] [--pile | --soup]

and on the PD scenes any of ``--full`` (``contact_coupling="full"``,
self-contact on), ``--no-tet-cols`` (a soup off the tet-column path, on
the generic path with the block preconditioner) and ``--entry-floor`` (the
floor's entry list, ``dense_floor=False``), e.g. ``--collisions --full``
or ``--no-tet-cols --collisions`` on the soup, ``--mixed --full``, or
``--mesh --entry-floor``.

Builds the 500k-particle soup (``create_tet_soup(n_tets, spacing=1.6,
scale=0.8, w=2000.0, height=0.5, jitter=0.05)``, 125,000 tets by default),
self-contact off, or on with ``--collisions``; or, with ``--mesh``, the
imported 110,592-node / 622,938-tet mesh
(``scripts/refbench/tet_cube_mesh_100k.txt``, w = 1000, self-contact off),
which runs the generic path; or, with ``--cloth``, the 512 x 512 rigged
cloth of ``scene/rigged_cloth.py`` (262,144 nodes; distance, bend, shape and
goal constraints; self-contact off), the generic path's other families, with
its fixed region turned by 0.05 rad before the windows; or, with
``--mixed``, the cloth-over-soup scene of ``scene/mixed_drape.py`` (125,000
tets and a 100 x 100 sheet, 510,000 nodes, self-contact on through the
super-body detection), the generic path with contact terms and the banded
tet operator; or, with ``--boxes``, the pile of five ``create_box``es of
``scene/contact_piles.py`` (625 nodes, 960 triangles) with the default
arguments, self-contact through the per-triangle all-pairs branch (T16,
T17), or with ``--reference`` as well through ``broadphase_mode=
"reference"``; or, with ``--rope`` or ``--pile``, the PBD cells of
``scene/pbd_scenes.py`` at 131,072 particles by default (1,024 ropes of 128
nodes, or the node pile at the bench's density), collisions on; or, with
``--nets``, the crossing nets of ``scene/edge_nets.py`` with the bench's
arguments (edge-edge contacts, full coupling, ``reference_quirks=False``)
at nn = 256 by default (131,072 nodes; contact caps 262,144 above the
bench's nn = 24, 2,048 up to it), or with ``--node-cloud`` the node pile at 131,072
particles by default under the PD solver with node-node contacts on
(``max_node_node_contacts`` 16 per particle, so the cap never truncates),
or with ``--ensemble`` the ``ensemble_vmap`` cell of ``chip_smoke.py``
phase 13: 64 members by default of the 512-tet soup with self-contact, each
member's live nodes moved by a seeded offset, stepped by
``parallel.ensemble.ensemble_tick_n`` (its windows and counters sum over
the members), or with ``--ensemble-generic`` phase 15b's: 64 members by
default of ``tet_cube_drop`` (``scene/cube_drop.py``, 1,331 nodes each,
self-contact off) on the generic path, each member lifted by its own seeded
offset, or with ``--ensemble-contacts`` phase 16a's: the same with the
bench's self-contact (the super-body detection), or with ``--boxes`` as
well phase 16b's: 64 members by default of the box pile, each jittered by
its own seeded offset (the all-pairs detection), or with
``--ensemble-edges`` phase 17a's: 64 members by default of the crossing
nets at the bench's nn = 24 (``edge_nets.nets_ensemble``: edge-edge
contacts, full coupling), each jittered, or with ``--cloud`` as well phase
17b's: 64 PD node clouds of the bench's 8,192 nodes
(``pbd_scenes.cloud_ensemble``), or with ``--ensemble-pbd`` phase 18a's:
64 members by default of ``rope_pbd`` at the bench's 2,048 nodes
(``pbd_scenes.rope_ensemble``, collisions on), or with ``--pile`` as well
18b's: 64 of ``pbd_node_pile`` at 8,192 (``pile_ensemble``), or with
``--soup`` 18c's: 64 of the 512-tet soup under the PBD solver
(``chip_smoke.py``'s ``PBD_SOUP``: strain weight 1.0, collisions off,
``reference_quirks=False``), each member jittered by ±0.02.
It warms
up until the window it measures is contact-active: 30 ticks without
self-contact (the bottom layer reaches the floor at tick ~25), 45 with it (the layers meet at tick ~40, once the
bottom one rests on the floor), 75 for the mesh (its bottom, 3.0 above the
floor, meets it at tick 70), 25 for the cloth (it lands at tick ~19), 50 for
the mixed scene (the soup's layers meet at tick ~40, sheet and soup at tick
49), 30 for the boxes and their ensemble (they touch from tick 27); the PBD scenes tick by
tick until a tick has floor-active nodes and touching pairs (the ropes
reach the floor at tick ~42, the pile at once), the nets tick by tick
until a tick has live edge contacts (each window below then starts from
that tick's state: the nets latch within a few dozen ticks of it), the
ensemble 45 ticks as the soup with self-contact, the generic ensemble tick by
tick until every member has had floor-active nodes, the nets' ensemble 47
ticks (their dense contact phase begins near tick 48; each window starts
from that state, since members latch at the cap later), the node cloud and
its ensemble not at all (their pairs touch from the first tick), the PBD
ensembles tick by tick until every member has had floor-active nodes (and,
with collisions, touching pairs; the ropes after 35 ticks at once).  Then:

* times ``repeats`` runs of ``run_ticks(10)`` (host clock around work that
  ends in a synchronize) and prints each, for the spread;
* traces 10 ticks with ``torch.profiler`` and the device counters off, and
  prints the device's busy share of the traced wall time;
* traces 10 more with the counters on, prints the same share, the device
  time per kernel name, and the counters read once: floor-active node
  substeps, live contacts, broadphase cache rebuilds, CG trips, edge
  contacts and their hits before the cap, live and touching node pairs
  (for PBD: floor nodes, live and touching pairs per iteration, pair-cache
  rebuilds).

Prints the card's name and power limit first.  Needs a CUDA device.
"""

import subprocess
import sys
import time
from pathlib import Path

FLOOR_WARMUP, CONTACT_WARMUP, MESH_WARMUP, CLOTH_WARMUP, MIXED_WARMUP = 30, 45, 75, 25, 50
BOXES_WARMUP = 30
PBD_WARMUP = 35  # then tick by tick: the ropes reach the floor at tick ~42
NETS_ENS_WARMUP = 47  # the bench's nets have dense edge contacts from tick ~48
MESH = Path(__file__).resolve().parent.parent / "scripts" / "refbench" / "tet_cube_mesh_100k.txt"


def device_events(prof):
    """The CUDA events of a finished ``torch.profiler`` run, each with its
    self device time in µs: ``[(event, µs)]`` (newer PyTorch names the
    field ``self_device_time_total``, older ``self_cuda_time_total``)."""
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    attr = ("self_device_time_total" if events and hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    return [(e, getattr(e, attr)) for e in events]


def main(n_tets=125_000, repeats=5, collisions=False, mesh=False, cloth=False, mixed=False,
         boxes=False, reference=False, rope=False, pile=False, full=False, tet_cols=True,
         dense_floor=True, nets=False, cloud=False, members=0, drop=False, contacts=False,
         edges=False, pbd_ens=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import pies_tpu_torch as pt
    from pies_tpu_torch.solver import pbd, pd

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    unit = "tets" if pbd_ens == "soup" else "nodes"
    scene = (f"an ensemble of {members} PBD {pbd_ens}s ({n_tets} {unit} each)" if pbd_ens
             else f"an ensemble of {members} PD node clouds of {n_tets} nodes" if edges and cloud
             else f"an ensemble of {members} crossing nets, nn = {n_tets}" if edges
             else "the 110k mesh" if mesh else "the 512 x 512 rigged cloth" if cloth
             else "the cloth over the soup" if mixed else "the box pile" if boxes
             else f"the PBD rope fleet, {n_tets} particles" if rope
             else f"the PBD node pile, {n_tets} particles" if pile
             else f"the crossing nets, nn = {n_tets}" if nets
             else f"the PD node cloud, {n_tets} particles" if cloud
             else f"an ensemble of {members} box piles" if members and boxes
             else f"an ensemble of {members} tet_cube_drop meshes" if drop
             else f"an ensemble of {members} 512-tet soups" if members else "the soup")
    nets = nets or (edges and not cloud)
    collisions = (collisions or mixed or boxes or rope or pile or full or nets
                  or members) and not (cloud or (drop and not contacts) or pbd_ens == "soup")
    mode = "reference" if reference else "celllist"
    coupling = "full" if full or nets else "recentered"
    print(f"card: {smi}; {scene}, self-contact {'on' if collisions else 'off'},"
          f" broadphase_mode {mode}, contact_coupling {coupling}, tet_cols {tet_cols},"
          f" dense_floor {dense_floor}")
    solver = pt.SolverName.PBD if rope or pile else pt.SolverName.PD
    if nets:
        from pies_tpu_torch.scene.edge_nets import BENCH_CAPS, BENCH_NN, solver_args

        caps = BENCH_CAPS if n_tets <= BENCH_NN else 128 * BENCH_CAPS
        s = pt.Solver(pt.SolverOptions(solver=solver), **solver_args(caps))
    elif cloud:
        s = pt.Solver(pt.SolverOptions(solver=solver), enable_collisions=False,
                      enable_node_collisions=True,
                      budget_overrides=dict(max_node_node_contacts=16 * n_tets))
    else:
        s = pt.Solver(pt.SolverOptions(solver=solver), enable_collisions=collisions,
                      broadphase_mode=mode, contact_coupling=coupling)

    def configure():
        """The StepConfig fields of --no-tet-cols and --entry-floor, set
        once the scene is built and before the warm-up."""
        if not (tet_cols and dense_floor):
            import dataclasses

            s._prepare()
            s._config = dataclasses.replace(s.config, tet_cols=tet_cols,
                                            dense_floor=dense_floor)

    new_counters = (pbd if rope or pile else pd).new_counters
    states = None
    if pbd_ens:
        from .parallel import ensemble
        from .scene.pbd_scenes import pbd_ensemble, pile_ensemble, rope_ensemble

        if pbd_ens == "soup":
            s, states = pbd_ensemble(
                lambda s_: s_.create_tet_soup(n_tets, spacing=1.6, scale=0.8, w=1.0, height=0.5,
                                              jitter=0.05), members, s.device,
                enable_collisions=False, reference_quirks=False)
        else:
            s, states = (pile_ensemble if pbd_ens == "pile" else rope_ensemble)(
                members, n_tets, s.device)
        env = (s.topology, s.current_params(), s.config)
        keys = ("floor_active", "touching") if s.config.enable_collisions else ("floor_active",)
        first = PBD_WARMUP if pbd_ens == "rope" else 0
        if first:
            ensemble.ensemble_tick_n(states, *env, first)
        seen = torch.zeros((len(keys), members), dtype=torch.bool, device=s.device)
        for tick in range(first + 1, first + 121):
            c = pbd.new_counters(s.device, members)
            ensemble.ensemble_tick(states, *env, counters=c)
            for i, k in enumerate(keys):
                seen[i] |= c[k] > 0
            if bool(seen.all()):
                break
        print(f"every member has had {', '.join(keys)} by tick {tick}")
        new_counters = lambda device: pbd.new_counters(device, members)  # noqa: E731
    elif edges:
        from .parallel import ensemble

        if cloud:
            from .scene.pbd_scenes import cloud_ensemble

            s, states = cloud_ensemble(members, n_tets, s.device)
        else:
            from .scene.edge_nets import nets_ensemble

            s, states = nets_ensemble(members, n_tets, s.device)
        env = (s.topology, s.current_params(), s.config)
        if not cloud:
            ensemble.ensemble_tick_n(states, *env, NETS_ENS_WARMUP)
        new_counters = lambda device: pd.new_counters(device, members)  # noqa: E731
    elif members and boxes:
        from .parallel import ensemble
        from .scene.contact_piles import add_box_pile, jittered_ensemble

        add_box_pile(s)
        s._prepare()
        states = jittered_ensemble(s.state, members, s._builder.num_nodes)
        env = (s.topology, s.current_params(), s.config)
        ensemble.ensemble_tick_n(states, *env, BOXES_WARMUP)
        new_counters = lambda device: pd.new_counters(device, members)  # noqa: E731
    elif drop:
        from .parallel import ensemble
        from .scene.cube_drop import add_cube_drop, lifted_ensemble

        ids = add_cube_drop(s, 10)
        s._prepare()
        states = lifted_ensemble(s.state, members, len(ids))
        env = (s.topology, s.current_params(), s.config)
        seen = torch.zeros(members, dtype=torch.bool, device=s.device)
        for tick in range(1, 121):
            c = pd.new_counters(s.device, members)
            ensemble.ensemble_tick(states, *env, counters=c)
            seen |= c["floor_active"] > 0
            if bool(seen.all()):
                break
        print(f"every member has had floor-active nodes by tick {tick}")
        new_counters = lambda device: pd.new_counters(device, members)  # noqa: E731
    elif members:
        import numpy as np

        from .parallel import ensemble

        s.create_tet_soup(512, spacing=1.6, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
        s._prepare()
        states = ensemble.stack_ensemble(s.state, members)
        live = s._builder.num_nodes
        for b in range(members):
            off = np.random.default_rng(b).uniform(-0.02, 0.02, (live, 3)).astype(np.float32)
            states.positions[b, :live] += torch.from_numpy(off).to(s.device)
            states.prev_positions[b, :live] += torch.from_numpy(off).to(s.device)
        env = (s.topology, s.current_params(), s.config)
        ensemble.ensemble_tick_n(states, *env, CONTACT_WARMUP)
        new_counters = lambda device: pd.new_counters(device, members)  # noqa: E731
    elif nets and not members:
        from pies_tpu_torch.scene.edge_nets import add_crossing_nets

        add_crossing_nets(s, n_tets)
        for _ in range(150):
            s.counters = new_counters(s.device)
            s.run_ticks(1)
            c, s.counters = s.counters, None
            if int(c["edge_contacts"]) > 0:
                break
        print(f"edge contacts from tick {s.ticks}")
    elif cloud and not members:
        from pies_tpu_torch.scene.pbd_scenes import add_node_pile

        add_node_pile(s, n_tets)
    elif rope or pile:
        from pies_tpu_torch.scene.pbd_scenes import add_node_pile, add_rope_fleet

        (add_rope_fleet if rope else add_node_pile)(s, n_tets)
        s.run_ticks(PBD_WARMUP if rope else 2)
        for _ in range(60):
            s.counters = new_counters(s.device)
            s.run_ticks(1)
            c, s.counters = s.counters, None
            if int(c["floor_active"]) > 0 and int(c["touching"]) > 0:
                break
        print(f"contact-active from tick {s.ticks}")
    elif boxes:
        from pies_tpu_torch.scene.contact_piles import add_box_pile

        add_box_pile(s)
        configure()
        s.run_ticks(BOXES_WARMUP)
    elif mixed:
        from pies_tpu_torch.scene.mixed_drape import add_mixed_drape

        add_mixed_drape(s, n_tets, 100)
        configure()
        s.run_ticks(MIXED_WARMUP)
    elif mesh:
        from pies_tpu_torch.scene.mesh_dump import add_tet_mesh, load_mesh_txt

        add_tet_mesh(s, *load_mesh_txt(MESH))
        configure()
        s.run_ticks(MESH_WARMUP)
    elif cloth:
        from pies_tpu_torch.scene.rigged_cloth import add_rigged_cloth, fixed_region_matrix

        add_rigged_cloth(s, 512, scale=0.1, height=0.3, w=5000.0)
        configure()
        s.run_ticks(CLOTH_WARMUP)
        s.update_fixed_regions([fixed_region_matrix(512, 0.1, 0.3, 0.05)])
    else:
        s.create_tet_soup(n_tets, spacing=1.6, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
        configure()
        s.run_ticks(CONTACT_WARMUP if collisions else FLOOR_WARMUP)
    # The nets latch within a few dozen ticks of their first contacts, so
    # every window of theirs starts from the state after that tick.
    from .state import clone_state

    start = clone_state(s.state if states is None else states) if nets else None

    def rewind():
        nonlocal states
        if start is not None and states is not None:
            states = clone_state(start)
        elif start is not None:
            s._state = clone_state(start)

    def run10(counters=None):
        """10 ticks, then one synchronize."""
        if states is not None:
            ensemble.ensemble_tick_n(states, *env, 10, counters=counters)
            torch.cuda.synchronize()
        else:
            s.counters = counters
            s.run_ticks(10)
            s.counters = None

    def failed():
        return bool(states.sim_failed.any()) if states is not None else s.sim_failed

    for r in range(repeats):
        rewind()
        t0 = time.perf_counter()
        run10()
        dt = (time.perf_counter() - t0) / 10
        print(f"run {r}: {dt * 1e3:.4f} ms/tick, {1 / dt:.2f} steps/s"
              + (f", {members / dt:.1f} scene-steps/s" if members else "")
              + (" (sim_failed latched in it)" if failed() else ""))

    def traced(counters):
        rewind()
        torch.cuda.synchronize()
        c = new_counters(s.device) if counters else None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run10(c)
            wall = time.perf_counter() - t0
        counts = {k: int(v.sum()) for k, v in c.items()} if counters else None
        events = device_events(prof)
        busy_us = sum(us for _, us in events)
        if failed():
            print("sim_failed latched in the traced window")
        print(f"traced 10 ticks (device counters {'on' if counters else 'off'}): wall"
              f" {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms"
              f" ({100 * busy_us / 1e6 / wall:.1f}% busy,"
              f" {100 - 100 * busy_us / 1e6 / wall:.1f}% idle)"
              + (f"; counters {counts}" if counters else ""))
        return events

    # The first traced window has the path as users run it; the second adds
    # the device counters, and its per-kernel times are printed.
    traced(False)
    for e, us in sorted(traced(True), key=lambda eu: -eu[1]):
        print(f"  {us / 10:10.2f} us/tick  x{e.count / 10:<5.1f} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    args = [int(a) for a in sys.argv[1:] if not a.startswith("--")]
    if "--nets" in flags:
        sys.exit(main(*(args or [256]), nets=True))
    if "--node-cloud" in flags:
        sys.exit(main(*(args or [131_072]), cloud=True))
    if "--ensemble-generic" in flags:
        sys.exit(main(512, *args[1:2], members=args[0] if args else 64, drop=True))
    if "--ensemble-pbd" in flags:
        kind = "pile" if "--pile" in flags else "soup" if "--soup" in flags else "rope"
        sys.exit(main({"rope": 2048, "pile": 8192, "soup": 512}[kind], *args[1:2],
                      members=args[0] if args else 64, pbd_ens=kind))
    if "--ensemble-edges" in flags:
        sys.exit(main(8192 if "--cloud" in flags else 24, *args[1:2],
                      members=args[0] if args else 64, edges=True, cloud="--cloud" in flags))
    if "--ensemble-contacts" in flags:
        sys.exit(main(512, *args[1:2], members=args[0] if args else 64, drop=True, contacts=True,
                      boxes="--boxes" in flags))
    if "--ensemble" in flags:
        sys.exit(main(512, *args[1:2], members=args[0] if args else 64))
    if {"--rope", "--pile"} & set(flags):
        sys.exit(main(*(args or [131_072]), rope="--rope" in flags, pile="--pile" in flags))
    paths = dict(full="--full" in flags, tet_cols="--no-tet-cols" not in flags,
                 dense_floor="--entry-floor" not in flags)
    if {"--mesh", "--cloth", "--mixed", "--boxes"} & set(flags):
        sys.exit(main(125_000, *args[:1], mesh="--mesh" in flags, cloth="--cloth" in flags,
                      mixed="--mixed" in flags, boxes="--boxes" in flags,
                      reference="--reference" in flags, **paths))
    sys.exit(main(*args, collisions="--collisions" in flags, **paths))
