#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``pies_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):

0. The card: ``nvidia-smi`` name and power limit, torch / CUDA / nvcc
   versions, whether ``triton`` imports.  No CUDA device: exit 2.
1. Build the four kernels from ``pies_tpu_torch/kernels/csrc`` with nvcc
   (``-Xptxas -v`` output printed) and report the build time.
2. Each kernel against its plain PyTorch twin on the card, at the main
   path's shapes (125,000 tets, 500,000 nodes) from the seeded scene: T1
   forces within 1e-4 of the largest, T2 positions within 1e-4, T3 and T4
   within 1 ulp.  Times from CUDA events, kernel beside twin.
3. The main path: ``Solver(SolverOptions(solver=PD),
   enable_collisions=False)`` on ``create_tet_soup(125_000, spacing=1.6,
   scale=0.8, w=2000.0, height=0.5, jitter=0.05)``; ``run_ticks(3)`` warm-up
   and a timed ``run_ticks(10)``, launch counters reset to 0 before it.
   Checks: no sim_failed, finite positions, floor contact, every counter > 0.
   The same run with the plain twins on the card is timed too, and its final
   positions are held against the kernels' run.
4. Kernels against twins on the card over 40 ticks of a 4,096-tet soup:
   max |Δx| ≤ 1e-3.

The last two lines are the kernel table and the result as JSON objects.
"""

import json
import subprocess
import sys
import time

N_TETS = 125_000
SCENE = dict(spacing=1.6, scale=0.8, w=2000.0, height=0.5, jitter=0.05)


def run(cmd):
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    return (p.stdout + p.stderr).strip()


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_ulp(a, b):
    """Largest difference in units of the last place of float32 tensors."""
    import torch

    a, b = a.float(), b.float()
    m = torch.maximum(a.abs(), b.abs())
    ulp = torch.nextafter(m, torch.full_like(m, float("inf"))) - m
    d = (a - b).abs() / ulp
    return float(torch.where(a == b, torch.zeros_like(d), d).max())


def clone_state(s):
    import dataclasses

    return dataclasses.replace(
        s, **{f.name: getattr(s, f.name).clone() for f in dataclasses.fields(s)}
    )


def check(ok, what):
    if not ok:
        raise SystemExit(f"FAILED: {what}")
    print(f"  ok: {what}")


def main(n_tets=N_TETS, n_small=4096, dev=None):
    import torch

    # ---- phase 0
    print("phase 0: the card")
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs only on a GPU", file=sys.stderr)
        return 2
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}"
          f" device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    try:
        import triton  # noqa: F401

        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")

    import numpy as np

    import pies_tpu_torch as pt
    from pies_tpu_torch import kernels
    from pies_tpu_torch.constraints import projections as proj
    from pies_tpu_torch.solver import pd, step, tetcols

    print("nvcc: " + run([kernels._nvcc(), "--version"]).splitlines()[-1])
    dev = dev or torch.device("cuda", 0)

    # ---- phase 1
    print("phase 1: build")
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.lib()
    print(f"build + load {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds} s)")
    print("\n".join(l for l in kernels.build_log.splitlines() if "registers" in l or "spill" in l
                    or "Compiling entry" in l))

    # ---- phase 2
    print(f"phase 2: kernels against twins at {n_tets} tets, {4 * n_tets} nodes")
    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), enable_collisions=False, device=dev)
    s.create_tet_soup(n_tets, **SCENE)
    t0 = time.perf_counter()
    st, topo, cfg, params = s.state, s.topology, s._config, s.current_params()
    print(f"scene set-up {time.perf_counter() - t0:.2f} s, capacity {st.capacity}")
    # Seeded velocities with a downward drift, so the predicted positions of
    # the bottom layer fall below the floor threshold.
    rng = np.random.default_rng(0)
    vel = 0.5 * rng.standard_normal((st.capacity, 3)) + np.array([0.0, -40.0, 0.0])
    st.velocities.copy_(torch.from_numpy(vel.astype(np.float32)).to(dev) * st.node_mask[:, None])
    plane = 0.0

    rows = []

    def row(name, source, replaces, err, ms, plain_ms, tol_text):
        print(f"  {name}: max err {err:.3e} ({tol_text}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms))

    sk, sp = clone_state(st), clone_state(st)
    hk = pd.substep_head(sk, topo, params, cfg, True)
    hp = pd.substep_head_plain(sp, topo, params, cfg, True)
    torch.cuda.synchronize()
    ulps = max(max_ulp(a, b) for a, b in zip(hk, hp))
    err = max(float((a - b).abs().max()) for a, b in zip(hk, hp))
    check(ulps <= 1.0, f"T3 substep_head within 1 ulp (max {ulps} ulp)")
    check(float(hk[4].sum()) > 0, f"T3 floor-active nodes: {int(hk[4].sum())}")
    row("substep_head", "pies_tpu_torch/kernels/csrc/substep_ends.cu", "pies_tpu/solver/pd.py:59",
        err, cuda_ms(lambda: pd.substep_head(sk, topo, params, cfg, False), 50),
        cuda_ms(lambda: pd.substep_head_plain(sp, topo, params, cfg, False), 20), f"{ulps} ulp")

    x, msn, diag, wf, active = hk
    fk = proj.tet_force12(x, topo.strain, topo.volume, st.sim_failed)
    fp = proj.tet_force12_plain(x, topo.strain, topo.volume)
    torch.cuda.synchronize()
    scale = float(fp.abs().max())
    err = float((fk - fp).abs().max())
    check(err <= 1e-4 * scale, f"T1 tet_force12 within 1e-4 of max |f| = {scale:.1f}")
    row("tet_force12", "pies_tpu_torch/kernels/csrc/tet_force.cu",
        "pies_tpu/constraints/projections.py:311", err,
        cuda_ms(lambda: proj.tet_force12(x, topo.strain, topo.volume, st.sim_failed), 20),
        cuda_ms(lambda: proj.tet_force12_plain(x, topo.strain, topo.volume), 5),
        f"rel {err / scale:.2e}")

    args = (x, msn, diag, st.node_mask, wf, fk, topo, plane, cfg.iterations, st.sim_failed)
    ck = tetcols.substep_cols(*args)
    cp = tetcols.substep_cols_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(ck[:2], cp[:2]))
    r2err = float((ck[2] - cp[2]).abs().max())
    check(err <= 1e-4, "T2 tet_cols_substep x and static projection within 1e-4")
    print(f"  T2 residual: kernel {float(ck[2].sum().sqrt()):.6g}, plain"
          f" {float(cp[2].sum().sqrt()):.6g}, per-tet max diff {r2err:.3e}")
    row("tet_cols_substep", "pies_tpu_torch/kernels/csrc/tet_cols_substep.cu",
        "pies_tpu/solver/tetcols.py:263", err,
        cuda_ms(lambda: tetcols.substep_cols(*args), 20),
        cuda_ms(lambda: tetcols.substep_cols_plain(*args), 3), "abs")

    x_new, static_proj, _ = ck
    tk, tp = clone_state(st), clone_state(st)
    pd.substep_tail(tk, topo, params, active, x_new, static_proj)
    pd.substep_tail_plain(tp, topo, params, active, x_new, static_proj)
    torch.cuda.synchronize()
    fields = ("positions", "prev_positions", "velocities", "forces", "sim_failed")
    ulps = max(max_ulp(getattr(tk, f), getattr(tp, f)) for f in fields[:4])
    err = max(float((getattr(tk, f) - getattr(tp, f)).abs().max()) for f in fields[:4])
    check(ulps <= 1.0 and torch.equal(tk.sim_failed, tp.sim_failed),
          f"T4 substep_tail within 1 ulp (max {ulps} ulp), same latch")
    row("substep_tail", "pies_tpu_torch/kernels/csrc/substep_ends.cu", "pies_tpu/solver/pd.py:316",
        err, cuda_ms(lambda: pd.substep_tail(tk, topo, params, active, x_new, static_proj), 50),
        cuda_ms(lambda: pd.substep_tail_plain(tp, topo, params, active, x_new, static_proj), 20),
        f"{ulps} ulp")
    del s, st, sk, sp, tk, tp, hk, hp, fk, fp, ck, cp, args

    # ---- phase 3
    print(f"phase 3: the main path, {4 * n_tets} particles")
    counters = {"substep_head": pd.substep_head, "tet_force12": proj.tet_force12,
                "tet_cols_substep": tetcols.substep_cols, "substep_tail": pd.substep_tail}

    def drive(plain, n, ticks):
        """``ticks`` ticks after a 3-tick warm-up; returns the solver and the
        seconds per tick.  The kernels run through ``Solver.run_ticks``, the
        plain twins through the same tick loop with ``plain=True``."""
        s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), enable_collisions=False,
                      device=dev)
        s.create_tet_soup(n, **SCENE)

        def run(k):
            if plain:
                step.tick_n(s.state, s.topology, s.current_params(), s._config, k, plain=True)
                torch.cuda.synchronize()
            else:
                s.run_ticks(k)

        run(3)
        t0 = time.perf_counter()
        run(ticks)
        return s, (time.perf_counter() - t0) / ticks

    for f in counters.values():
        f.launches = 0
    s, sec = drive(False, n_tets, 10)
    launches = {name: f.launches for name, f in counters.items()}
    live = 4 * n_tets
    pos = s.state.positions[:live]
    check(not s.sim_failed, "no sim_failed")
    check(bool(torch.isfinite(pos).all()), "all positions finite")
    ymin = float(pos[:, 1].min())
    check(ymin < 0.5, f"floor contact exercised (min y {ymin:.4f})")
    check(all(n > 0 for n in launches.values()), f"every kernel launched: {launches}")
    print(f"  kernels: {sec * 1e3:.3f} ms/tick, {1.0 / sec:.2f} steps/s ({smi};"
          f" residual {s.last_residual:.4g})")
    sp_, sec_p = drive(True, n_tets, 10)
    check(all(f.launches == launches[name] for name, f in counters.items()),
          "the twins launch no kernel")
    print(f"  plain twins: {sec_p * 1e3:.3f} ms/tick, {1.0 / sec_p:.2f} steps/s ({smi})")
    d = float((sp_.state.positions[:live] - pos).abs().max())
    check(d <= 1e-3, f"kernels and twins agree after 13 ticks: max |dx| {d:.3e}")
    del s, sp_, pos

    # ---- phase 4
    print(f"phase 4: 40 ticks of a {n_small}-tet soup, kernels against twins")
    runs = []
    for plain in (False, True):
        s, _ = drive(plain, n_small, 37)  # 3 + 37 = 40 ticks
        check(not s.sim_failed, f"no sim_failed (plain={plain})")
        runs.append(s.state.positions[: 4 * n_small])
    d = float((runs[0] - runs[1]).abs().max())
    check(d <= 1e-3, f"trajectories agree: max |dx| {d:.3e}")
    check(float(runs[0][:, 1].min()) < 0.05, "the floor was reached")

    for r in rows:
        r["launches"] = launches[r["name"]]
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
