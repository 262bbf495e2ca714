#!/usr/bin/env python3
"""Per-call device and host time of the main path's contact kernels, and
the main path's self-contact tick, on one GPU.

    python3 scripts/contact_kernels_profile.py [n_tets] [--label NAME] [--json PATH]
                                               [--record-rounds N]

Builds the soup of ``bench.py`` with self-contact (``create_tet_soup(n_tets,
spacing=1.6, scale=0.8, w=2000.0, height=0.5, jitter=0.05)``, 125,000 tets
by default) and runs 45 ticks of the kernels, the state ``chip_smoke.py``'s
phases 2b and 3b start from.  Then:

* on that state (phase 2b's: one substep's head, the cached pairs), each
  wrapper call of T5 (as found, and with a rebuild forced), T6, T7's setup,
  T7's force, T7's setup and 4 forces (``chip_smoke.py``'s ``pt_coupling``
  row), T2's one contact iteration (and, where the tree has it, with T7's
  force fused into T2's launch), T2's contact-free substep (all
  iterations in one launch), T2's whole contact substep as ``pd_substep``
  runs it (``tetcols.contact_substep`` where the tree has it, else one
  fused call an iteration; where T2 takes T1's force as ``f0``, as that
  tree's ``pd_substep`` passes it), both substeps again with iteration 0's
  force computed inside T2 where T2 takes ``f0`` (``f0 = None``, the form
  a tree without ``f0`` always runs), T8 and T1: CUDA-event ms per call,
  host µs per call (the enqueue, no synchronize), and from
  ``torch.profiler`` the device µs, the count of each kernel per call by
  name, and the memcpys and memsets per call;
* over ticks 46-55 (phase 3b's window), restarting from a copy of the
  state at tick 45: ms/tick from the host clock around ``run_ticks(10)``
  (twice), and a traced window: device busy, kernels, memcpys and memsets
  per tick, device µs per tick by kernel name; the window's cache rebuilds
  and contacts (device counters) and T1-T8 wrapper calls a tick; its
  reductions by input shape (a profile with shapes);
* the ``-Xptxas -v`` lines of T1's and T5's sources (registers, spills,
  stack) and T1's registers and resident blocks an SM;
* with ``--record-rounds N``, the profiler's record loss: each call above
  profiled N times over 5 calls in two forms, the tracer started just
  before the counted calls (the form of ``chip_smoke.py``'s per-call
  table) and after a traced warm-up step of 5 calls that the profiler
  discards (``schedule(warmup=1, active=1)``); for each form and
  call, the rounds whose count of some kernel, memcpy or memset name is
  not a multiple of 5 or that recorded nothing, and the counts per call
  they show;
* the window's ticks enqueued by ``step.tick_n`` under
  ``torch.cuda.set_sync_debug_mode("warn")`` (every synchronizing call it
  makes, with its Python line) and then ``"error"``, the closing
  ``torch.cuda.synchronize()`` outside.

Prints the card's name and power limit first and, with ``--json``, writes
what it printed (labelled ``--label``) as JSON to that path.  Imports no
JAX.  Needs a CUDA device.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
import time
import warnings
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SCENE = dict(spacing=1.6, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
CONTACT_WARMUP = 45


def kind_of(name: str) -> str:
    return "memcpy" if name.startswith("Memcpy") else "memset" if name.startswith(
        "Memset") else "kernel"


def profile_calls(fn, reps):
    """``fn`` run ``reps`` times under ``torch.profiler`` (device activity
    only) after one warm-up call: ``{name: (calls per fn, device µs per
    fn)}``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pies_tpu_torch.tick_profile import device_events

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / reps, us / reps) for e, us in device_events(prof)}


def record_rounds(fn, reps, rounds, warmup):
    """``rounds`` profiles of ``reps`` calls of ``fn`` (device activity only),
    the tracer started just before them or, with ``warmup``, ``reps`` calls
    earlier in a warm-up step whose records the profiler discards: the
    rounds that lost records, ``[{name: count per call}]`` of each round
    that recorded nothing or a count ``reps`` does not divide."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from pies_tpu_torch.tick_profile import device_events

    fn()
    torch.cuda.synchronize()
    lossy = []
    for _ in range(rounds):
        plan = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup else None
        with profile(activities=[ProfilerActivity.CUDA], schedule=plan) as prof:
            for _ in range(2 if warmup else 1):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                if warmup:
                    prof.step()
        counts = {e.key: e.count for e, _ in device_events(prof)}
        if not counts or any(c % reps for c in counts.values()):
            lossy.append({k: c / reps for k, c in counts.items()})
    return lossy


def summary(events):
    out = defaultdict(float)
    for name, (calls, us) in events.items():
        out[kind_of(name) + "s"] += calls
        out["device_us"] += us
    return dict(out)


def ptxas_lines(log, sources):
    """The ``-Xptxas -v`` lines of ``sources`` in a build log: each kernel's
    entry, registers, spills and stack frame."""
    out, keep = [], False
    for line in log.splitlines():
        if line.startswith("== "):
            keep = line[3:].strip() in sources
            src = line[3:].strip()
            continue
        if keep and ("Compiling entry" in line or "Used" in line or "spill" in line):
            out.append(f"{src}: {line.split(':', 1)[-1].strip()}")
    return out


def wrapper_launches():
    """The main path's wrappers (T1-T8), each with its ``launches`` count."""
    from pies_tpu_torch.collision import broadphase
    from pies_tpu_torch.constraints import projections as proj
    from pies_tpu_torch.solver import pd, tetcols

    return (pd.substep_head, proj.tet_force12, tetcols.substep_cols, tetcols.contact_substep,
            pd.substep_tail, broadphase.body_broadphase, broadphase.pt_narrowphase,
            tetcols.pt_coupling_setup, tetcols.pt_force, pd.pt_tail)


def main(n_tets=125_000, label="run", dev=None, json_path=None, record=0):
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import pies_tpu_torch as pt
    from pies_tpu_torch import kernels
    from pies_tpu_torch.collision import broadphase
    from pies_tpu_torch.collision.batches import CollisionSet
    from pies_tpu_torch.constraints import projections as proj
    from pies_tpu_torch.solver import pd, step, tetcols
    from pies_tpu_torch.state import clone_state
    from pies_tpu_torch.tick_profile import device_events

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable ({e.__class__.__name__})"
    report = {"label": label, "card": smi, "n_tets": n_tets}
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    report["ptxas"] = ptxas_lines(kernels.build_log, ("tet_force.cu", "body_broadphase.cu"))
    for line in report["ptxas"]:
        print(f"  {line}")
    attrs = getattr(kernels.lib(), "pies_tet_force12_attrs", None)
    if attrs is not None:
        import ctypes

        out = (ctypes.c_int * 3)()
        kernels.check(attrs(ctypes.addressof(out)), "tet_force12_attrs")
        report["t1_attrs"] = dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2])
        print(f"T1: {out[0]} registers a thread, {out[1]} local bytes a thread, {out[2]} blocks"
              " of 128 an SM resident (cudaFuncGetAttributes,"
              " cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    dev = dev or torch.device("cuda", 0)

    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), enable_collisions=True, device=dev)
    s.create_tet_soup(n_tets, **SCENE)
    s.run_ticks(CONTACT_WARMUP)
    if s.sim_failed:
        raise SystemExit("sim_failed in the warm-up")
    start = clone_state(s.state)

    # Phase 2b's state and one call of each wrapper on it.
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    lay = broadphase.body_layout(cfg, topo.tri_mask.shape[0])
    sc = broadphase.scalars(params)
    failed = st.sim_failed
    x, msn, diag, wf, active = pd.substep_head_plain(clone_state(st), topo, params, cfg, True)
    prev, tmask = st.prev_positions, topo.tri_mask
    ov = torch.zeros(1, dtype=torch.int32, device=dev)
    found, forced = st.bp.clone(), st.bp.clone()
    cache = st.bp.clone()
    pk = broadphase.pt_narrowphase(x, prev, tmask, cache, lay, sc, ov, failed)
    colls = CollisionSet(floor_active=active, pt_idx=pk[0], pt_mask=pk[1], pt_count=pk[2],
                         overflow=torch.zeros(1, dtype=torch.int32, device=dev))
    _, h2 = pd._h_h2(params)
    thick = params.collision_thickness
    dk = diag.clone()
    inc, ptd = tetcols.pt_coupling_setup(colls, st.mass, topo, h2, dk, wf, failed)
    contact = tetcols.pt_force(x, colls, inc, thick, failed)
    pt_args = (ptd, contact, inc.row_start, colls.pt_count)
    plane = pd.floor_plane(params, cfg.reference_quirks)
    f0 = proj.tet_force12(x, topo.strain, topo.volume, failed)
    # (a tree whose T2 takes T1's force as ``f0`` runs the main path with it)
    takes_f0 = "f0" in inspect.signature(tetcols.substep_cols).parameters
    main_f0 = f0 if takes_f0 else None

    def t2_in(x_, d_, first=None):  # (T2's arguments up to the topology)
        return (x_, msn, d_, st.node_mask, wf) + ((first,) if takes_f0 else ())

    x_new, static_proj, _ = tetcols.substep_cols(*t2_in(x, dk, f0), topo, plane, 1, failed,
                                                 pt_args)
    sk, xk = clone_state(st), x_new.clone()
    torch.cuda.synchronize()
    n_contacts, nnz = int(pk[2][0]), int(inc.row_start[-1])
    on = inc.row_start[1:] > inc.row_start[:-1]
    n_inc, contact_tets = int(on.sum()), int(on.view(-1, 4).any(1).sum())
    print(f"phase 2b's state: {n_contacts} contacts, {nnz} incidence entries over {n_inc}"
          f" nodes, {contact_tets} contact tets of {st.capacity // 4},"
          f" {int(found.valid.sum())} valid lanes of {lay.lanes}")
    report["state"] = dict(contacts=n_contacts, entries=nnz, incident_nodes=n_inc,
                           contact_tets=contact_tets, tets=st.capacity // 4,
                           valid_lanes=int(found.valid.sum()), lanes=lay.lanes)

    def couple():
        d = diag.clone()
        inc_c, _ = tetcols.pt_coupling_setup(colls, st.mass, topo, h2, d, wf, failed)
        for _ in range(cfg.iterations):
            tetcols.pt_force(x, colls, inc_c, thick, failed)

    def rebuild():
        forced.fresh.zero_()
        broadphase.body_broadphase(x, prev, tmask, forced, lay, sc, ov, failed)

    calls = {
        "T5 as found": lambda: broadphase.body_broadphase(x, prev, tmask, found, lay, sc, ov,
                                                          failed),
        "T5 rebuild (with the fill that forces it)": rebuild,
        "T6": lambda: broadphase.pt_narrowphase(x, prev, tmask, cache, lay, sc, ov, failed),
        "T7 setup": lambda: tetcols.pt_coupling_setup(colls, st.mass, topo, h2, dk, wf, failed),
        "T7 force": lambda: tetcols.pt_force(x, colls, inc, thick, failed),
        f"T7 setup + {cfg.iterations} forces": couple,
        "T2 one contact iteration": lambda: tetcols.substep_cols(
            *t2_in(x, dk), topo, plane, 1, failed, pt_args),
        "T8": lambda: pd.pt_tail(sk, params, cfg, colls, inc, xk, static_proj),
        "T1": lambda: proj.tet_force12(x, topo.strain, topo.volume, failed),
    }
    if hasattr(tetcols, "contact_substep"):  # (the main path's T2, one iteration)
        calls["T2 one contact iteration, T7's force fused in"] = lambda: tetcols.contact_substep(
            *t2_in(x, dk), topo, plane, 1, failed, ptd, colls, inc, thick)
    elif "fused" in inspect.signature(tetcols.substep_cols).parameters:
        calls["T2 one contact iteration, T7's force fused in"] = lambda: tetcols.substep_cols(
            *t2_in(x, dk), topo, plane, 1, failed,
            (ptd, None, inc.row_start, colls.pt_count), fused=(colls, inc, thick))

    def contact_substep(first=None):  # (T2's contact substep as pd_substep runs it)
        if hasattr(tetcols, "contact_substep"):
            return tetcols.contact_substep(*t2_in(x, dk, first), topo, plane, cfg.iterations,
                                           failed, ptd, colls, inc, thick)
        x_it = x
        for it in range(cfg.iterations):
            x_it, _, _ = tetcols.substep_cols(
                *t2_in(x_it, dk, first if it == 0 else None), topo, plane, 1, failed,
                (ptd, None, inc.row_start, colls.pt_count), fused=(colls, inc, thick))

    calls[f"T2 contact-free substep, {cfg.iterations} iterations"] = lambda: tetcols.substep_cols(
        *t2_in(x, diag, main_f0), topo, plane, cfg.iterations, failed)
    calls[f"T2 contact substep, {cfg.iterations} iterations"] = lambda: contact_substep(main_f0)
    if takes_f0:  # (iteration 0's force inside T2, as a tree without f0 runs it)
        calls[f"T2 contact substep without T1's force, {cfg.iterations} iterations"] = (
            contact_substep)
        calls[f"T2 contact-free substep without T1's force, {cfg.iterations} iterations"] = (
            lambda: tetcols.substep_cols(*t2_in(x, diag), topo, plane, cfg.iterations,
                                         failed))
    if hasattr(tetcols, "contact_occupancy"):
        report["t2_contact_blocks_per_sm"] = tetcols.contact_occupancy()
        print(f"T2's contact launch: {report['t2_contact_blocks_per_sm']} blocks an SM resident"
              " (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    report["calls"] = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        reps = 20
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        events = profile_calls(fn, 10)
        tot = summary(events)
        print(f"{name}: {ms:.4f} ms (events), host {host_us:.1f} us/call, device"
              f" {tot.get('device_us', 0.0):.2f} us/call, {tot.get('kernels', 0):g} kernels,"
              f" {tot.get('memcpys', 0):g} memcpys, {tot.get('memsets', 0):g} memsets per call"
              f" ({smi})")
        for key, (n, us) in sorted(events.items(), key=lambda kv: -kv[1][1]):
            print(f"    {us:9.2f} us x{n:<4g} {key[:100]}")
        report["calls"][name] = dict(ms=ms, host_us=host_us, **tot,
                                     events={k: list(v) for k, v in events.items()})
    if record:
        report["record_loss"] = {}
        for warmup in (False, True):
            form = "after a discarded warm-up step" if warmup else "tracer started at the calls"
            print(f"profiler record loss, {record} rounds of 5 calls each, {form}:")
            for name, fn in calls.items():
                lossy = record_rounds(fn, 5, record, warmup)
                report["record_loss"][f"{name}; {form}"] = lossy
                print(f"  {name}: {len(lossy)} of {record} rounds lost records"
                      + "".join(f"; {r}" for r in lossy[:3]))

    # Phase 3b's window: ticks 46-55 from the state at tick 45.
    def rewind():
        s._state = clone_state(start)
        torch.cuda.synchronize()

    per_tick = []
    for _ in range(2):
        rewind()
        t0 = time.perf_counter()
        s.run_ticks(10)
        per_tick.append((time.perf_counter() - t0) / 10 * 1e3)
    print(f"3b window (ticks 46-55): {', '.join(f'{v:.4f}' for v in per_tick)} ms/tick ({smi})")
    from torch.profiler import ProfilerActivity, profile

    rewind()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.run_ticks(10)
        wall = (time.perf_counter() - t0) * 1e3
    events = {e.key: (e.count / 10, us / 10) for e, us in device_events(prof)}
    tot = summary(events)
    print(f"3b traced window: wall {wall / 10:.4f} ms/tick, device busy"
          f" {tot.get('device_us', 0.0):.2f} us/tick, {tot.get('kernels', 0):g} kernels,"
          f" {tot.get('memcpys', 0):g} memcpys, {tot.get('memsets', 0):g} memsets per tick")
    for key, (n, us) in sorted(events.items(), key=lambda kv: -kv[1][1]):
        print(f"    {us:9.2f} us/tick x{n:<5g} {key[:100]}")
    report["window"] = dict(ms_per_tick=per_tick, traced_wall_ms_per_tick=wall / 10, **tot,
                            events={k: list(v) for k, v in events.items()})

    # The window's cache rebuilds (device counters) and wrapper calls.
    rewind()
    wrappers = wrapper_launches()
    for f in wrappers:
        f.launches = 0
    s.counters = pd.new_counters(dev)
    s.run_ticks(10)
    torch.cuda.synchronize()
    counts = {k: int(v.sum()) for k, v in s.counters.items()}
    s.counters = None
    calls_tick = sum(f.launches for f in wrappers) / 10
    by_wrapper = {f"{f.__module__.rsplit('.', 1)[-1]}.{f.__name__}": f.launches / 10
                  for f in wrappers if f.launches}
    print(f"3b window: {counts['rebuilds']} cache rebuilds in 10 ticks, {counts['contacts']}"
          f" contacts, {calls_tick:g} wrapper calls a tick {by_wrapper}")
    report["window"].update(rebuilds=counts["rebuilds"], contacts=counts["contacts"],
                            wrapper_calls=calls_tick, wrappers=by_wrapper)

    # The window's reductions (aten::sum and the like) by input shape: the
    # per-tet residual f32[tets] is pd_substep's last ``torch.sum``.
    rewind()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        s.run_ticks(2)
        torch.cuda.synchronize()
    sums = []
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::sum", "aten::amax", "aten::max", "aten::any"):
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            sums.append(dict(op=e.key, calls_per_tick=e.count / 2, device_us_per_tick=us / 2,
                             input_shapes=str(e.input_shapes)))
    for row in sorted(sums, key=lambda r: -r["device_us_per_tick"]):
        print(f"  {row['op']} x{row['calls_per_tick']:g} a tick, {row['device_us_per_tick']:.2f}"
              f" device us a tick, inputs {row['input_shapes']}")
    report["window"]["reductions"] = sums

    # The window's ticks enqueued under the sync check.
    sites = defaultdict(int)
    rewind()
    env = (s.state, s.topology, s.current_params(), s.config)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step.tick_n(*env, 10)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for w in caught:  # (not the mode's own notice that it is a prototype)
        if "called a synchronizing" in str(w.message):
            sites[f"{Path(w.filename).name}:{w.lineno}"] += 1
    print(f"sync check (warn): {sum(sites.values())} synchronizing calls in 10 ticks:"
          f" {dict(sites)}")
    rewind()
    env = (s.state, s.topology, s.current_params(), s.config)
    torch.cuda.set_sync_debug_mode("error")
    try:
        step.tick_n(*env, 10)
        error = None
    except RuntimeError as e:
        error = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"sync check (error): {'passed' if error is None else 'raised: ' + error}")
    report["sync"] = dict(sites=dict(sites), error=error)
    if json_path:
        out = Path(json_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    name = argv[argv.index("--label") + 1] if "--label" in argv else "run"
    path = argv[argv.index("--json") + 1] if "--json" in argv else None
    record = int(argv[argv.index("--record-rounds") + 1]) if "--record-rounds" in argv else 0
    nums = [int(a) for i, a in enumerate(argv) if a.isdigit() and argv[i - 1] != "--record-rounds"]
    sys.exit(main(*nums[:1], label=name, json_path=path, record=record))
