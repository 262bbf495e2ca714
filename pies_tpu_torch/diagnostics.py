"""Observability: constraint residuals, step metrics, broadphase health and
profiler traces (port of ``pies_tpu/diagnostics.py``).

* :func:`constraint_residuals` — the mean violation per constraint family,
  the floor penetration and the largest node speed: kernel T28
  (``kernels/csrc/residuals.cu``) on the card, its plain twin
  :func:`constraint_residuals_plain` on the CPU;
* :func:`solver_stats` — a host snapshot of the residuals and the
  ``Solver``'s tick counters;
* :func:`broadphase_health` — the swept boxes wider than one and than
  2 − margin cells, the candidate demand of the active broadphase branch
  against its budget (``collision.broadphase.candidate_occupancy``, kernel
  T29) and the contact buffer's occupancy;
* :func:`trace` — a ``torch.profiler`` capture written to a directory.

The twin sums each family in the kernel's fixed order (blocks of 256 rows
by a pairwise tree, then the block partials, ``cg_reduce.cuh``), so the two
agree bit for bit.  Like the JAX package's ``math3d.svd3x3`` under XLA on
the CPU, the deformation gradient ``F = edges · Q⁻¹`` and ``FᵀF`` are
fused multiply-add chains (XLA's dot; the ``_flat`` forms that T1 copies
round each product instead, and their singular values differ from
``svd3x3``'s); the twin forms each fused step exactly in float64.
"""

from __future__ import annotations

import contextlib

import torch

from . import kernels
from .ops.math3d import det3x3_flat, eigh3x3_flat, ieee_div
from .solver.assembly import block_partials, finalize
from .state import SolverState
from .topology import Topology

KEYS = ("distance", "position", "strain", "volume", "bend", "floor_penetration", "max_speed")


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once: the product is exact in float64,
    the sum rounds there and then to float32 (the same float32 as one
    rounding except where the float64 sum lands on a float32 tie)."""
    return (a.double() * b.double() + c.double()).float()


def _norm(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                        u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                        u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)


def _mask(w: torch.Tensor) -> torch.Tensor:
    return (w > 0).to(torch.float32)


def _gradient(x: torch.Tensor, idx: torch.Tensor, qinv: torch.Tensor):
    """``F = edges · Q⁻¹`` per tet as a row-major 9-tuple of f32[C], each
    entry the chain ``fma(e2, q2k, fma(e1, q1k, e0·q0k))`` (the JAX
    package's einsum, ``pies_tpu/diagnostics.py:57-66``).  ``qinv`` is
    f32[9, C]."""
    p = x[idx.long()]
    e = [p[:, j + 1] - p[:, 0] for j in range(3)]
    return tuple(_fma(e[2][:, i], qinv[6 + k], _fma(e[1][:, i], qinv[3 + k],
                                                    e[0][:, i] * qinv[k]))
                 for i in range(3) for k in range(3))


def singular_values(f) -> tuple:
    """σ of ``math3d.svd3x3`` (sorted descending, non-negative) from a
    9-tuple F: ``FᵀF`` by fused chains, the cyclic Jacobi of ``eigh3x3``,
    ``sqrt(max(w, 0))``."""
    s = tuple(_fma(f[6 + i], f[6 + k], _fma(f[3 + i], f[3 + k], f[i] * f[k]))
              for i in range(3) for k in range(3))
    w, _ = eigh3x3_flat(s)
    return tuple(torch.sqrt(torch.clamp_min(wk, 0.0)) for wk in w)


def _strain_rows(x, b):
    sigma = singular_values(_gradient(x, b.idx, b.qinv))
    viol = [torch.clamp_min(b.lo - s, 0.0) + torch.clamp_min(s - b.hi, 0.0) for s in sigma]
    return torch.maximum(torch.maximum(viol[0], viol[1]), viol[2])


def _volume_rows(x, b):
    det = det3x3_flat(_gradient(x, b.idx, b.qinv))
    return torch.clamp_min(b.lo - det, 0.0) + torch.clamp_min(det - b.hi, 0.0)


def _bend_rows(x, b):
    pb = x[b.idx.long()]
    p2, p3, p4 = pb[:, 1] - pb[:, 0], pb[:, 2] - pb[:, 0], pb[:, 3] - pb[:, 0]
    n1, n2 = _cross(p2, p3), _cross(p2, p4)
    n1 = ieee_div(n1, torch.clamp_min(_norm(n1), 1e-20)[:, None])
    n2 = ieee_div(n2, torch.clamp_min(_norm(n2), 1e-20)[:, None])
    d = n1[:, 0] * n2[:, 0] + n1[:, 1] * n2[:, 1] + n1[:, 2] * n2[:, 2]
    return (torch.acos(torch.clamp(d, -1.0, 1.0)) - b.rest_angle).abs()


def _family_rows(state: SolverState, topo: Topology):
    """``(name, value f32[C], mask f32[C])`` of each family, the value
    already multiplied by the mask as the JAX package does (a NaN in a dead
    row stays NaN); an absent family has ``C = 0``."""
    x = state.positions
    empty = x.new_zeros(0)
    out = []
    d = topo.distance
    if d is not None and d.w.shape[0]:
        v = (_norm(x[d.idx[:, 1].long()] - x[d.idx[:, 0].long()]) - d.rest).abs()
        out.append(("distance", v * _mask(d.w), _mask(d.w)))
    else:
        out.append(("distance", empty, empty))
    p = topo.position
    if p.w.shape[0]:
        out.append(("position", _norm(x[p.idx.long()] - p.target) * _mask(p.w), _mask(p.w)))
    else:
        out.append(("position", empty, empty))
    for name, batch, fn in (("strain", topo.strain, _strain_rows),
                            ("volume", topo.volume, _volume_rows),
                            ("bend", topo.bend, _bend_rows)):
        if batch is not None and batch.w.shape[0]:
            out.append((name, fn(x, batch) * _mask(batch.w), _mask(batch.w)))
        else:
            out.append((name, empty, empty))
    m = state.node_mask
    out.append(("floor_penetration", torch.clamp_min(-x[:, 1], 0.0) * m, m))
    return out


def constraint_residuals_plain(state: SolverState, topo: Topology) -> dict:
    """Plain twin of kernel T28 (``pies_tpu/diagnostics.py:33-102``): the
    mean violation per family over its live rows (``w > 0``), the floor
    penetration below y = 0 over live nodes and the largest node speed, as
    0-d float32 tensors under the JAX package's keys.  Each sum is taken in
    the kernel's order."""
    out = {}
    for name, value, mask in _family_rows(state, topo):
        if value.numel() == 0:  # no row: 0 / max(0, 1)
            out[name] = value.new_zeros(())
            continue
        total, count = finalize(block_partials(value)), finalize(block_partials(mask))
        out[name] = ieee_div(total, torch.clamp_min(count, 1.0))
    speed = _norm(state.velocities) * state.node_mask
    out["max_speed"] = speed.max() if speed.numel() else speed.new_zeros(())
    return {k: out[k] for k in KEYS}


def _batch_args(batch, kind: str):
    """The C arguments of one family (null pointers and 0 rows when absent)."""
    if batch is None or batch.w.shape[0] == 0:
        return (None,) * {"distance": 3, "position": 3, "tet": 5, "bend": 3}[kind] + (0,)
    if kind == "distance":
        t = (batch.idx, batch.rest, batch.w)
    elif kind == "position":
        t = (batch.idx, batch.target, batch.w)
    elif kind == "tet":
        t = (batch.idx, batch.qinv, batch.lo, batch.hi, batch.w)
    else:
        t = (batch.idx, batch.rest_angle, batch.w)
    return tuple(a.data_ptr() for a in t) + (batch.w.shape[0],)


def constraint_residuals(state: SolverState, topo: Topology) -> dict:
    """Kernel T28 on a CUDA state, :func:`constraint_residuals_plain` on a
    CPU one (same result: a dict of 0-d float32 tensors on the state's
    device).  One launch per family present and one that reduces them."""
    x = state.positions
    if kernels.on_cpu(x):
        return constraint_residuals_plain(state, topo)
    dev = x.device
    batches = [b for b in (topo.distance, topo.position, topo.strain, topo.volume, topo.bend)
               if b is not None]
    kernels.require(dev, x, state.velocities, state.node_mask,
                    *(t for b in batches for t in vars(b).values()
                      if isinstance(t, torch.Tensor)))
    rows = [x.shape[0]] + [b.w.shape[0] for b in batches]
    parts = max(1, sum(kernels.scan_partials(r) for r in rows))
    psum, pcnt, pmax = (torch.empty(parts, dtype=torch.float32, device=dev) for _ in range(3))
    out = torch.empty(len(KEYS), dtype=torch.float32, device=dev)
    err = kernels.lib().pies_constraint_residuals(
        x.data_ptr(), state.velocities.data_ptr(), state.node_mask.data_ptr(), x.shape[0],
        *_batch_args(topo.distance, "distance"), *_batch_args(topo.position, "position"),
        *_batch_args(topo.strain, "tet"), *_batch_args(topo.volume, "tet"),
        *_batch_args(topo.bend, "bend"), psum.data_ptr(), pcnt.data_ptr(), pmax.data_ptr(),
        out.data_ptr(), kernels.stream(),
    )
    kernels.check(err, "constraint_residuals")
    constraint_residuals.launches += 1
    return dict(zip(KEYS, out.unbind(0)))


constraint_residuals.launches = 0


def solver_stats(solver) -> dict:
    """Host snapshot of a ``Solver``: its tick counters and the residuals
    (``pies_tpu/diagnostics.py:105-121``)."""
    solver._prepare()
    residuals = {k: float(v)
                 for k, v in constraint_residuals(solver.state, solver.topology).items()}
    return {
        "ticks": solver.ticks,
        "last_tick_seconds": solver.last_tick_seconds,
        "steps_per_sec": 1.0 / solver.last_tick_seconds if solver.last_tick_seconds else 0.0,
        "cg_residual": solver.last_residual,
        "sim_failed": solver.sim_failed,
        **residuals,
    }


def broadphase_health(solver) -> dict:
    """Coverage of the broadphase at the current state
    (``pies_tpu/diagnostics.py:124-203``): the items (triangles, or bodies
    when the scene has a body stride) whose swept box spans more than one
    cell and more than 2 − margin cells (those latch ``sim_failed``); with
    collisions on and triangles, the candidate demand against its budget
    (:func:`collision.broadphase.candidate_occupancy`) and the live
    point-triangle contacts of one detection against the contact buffer."""
    from .collision import broadphase
    from .state import clone_state

    solver._prepare()
    state, topo = solver.state, solver.topology
    params, cfg = solver.current_params(), solver.config
    x, prev = state.positions, state.prev_positions
    counts = broadphase.occupancy(x, prev, topo.triangles, topo.tri_mask,
                                  broadphase.occupancy_layout(cfg, topo.triangles.shape[0]),
                                  broadphase.scalars(params)).tolist()
    out = {"broadphase_oversize_items": counts[3], "broadphase_latching_items": counts[4]}
    if topo.triangles.shape[0] and cfg.enable_collisions:
        cmax, cmean, cap_c = broadphase.occupancy_result(counts, cfg, topo.triangles.shape[0])
        # One detection from the state as it is, on copies of its cache: the
        # JAX package's default_detect_collisions, whose new cache is dropped.
        cache = clone_state(state.bp) if state.bp is not None else None
        pt_idx, pt_mask, _, _, _ = broadphase.detect_point_tri_collisions(
            x, prev, topo.tri_mask, params, cfg, cache=cache,
            failed=torch.zeros_like(state.sim_failed), corners=topo.super_corners,
            adj=topo.super_adj, triangles=topo.triangles)
        live_pt, cap_pt = int(pt_mask.sum()), int(pt_idx.shape[0])
        out.update({
            "candidate_count_max": cmax,
            "candidate_count_mean": cmean,
            "candidate_budget": cap_c,
            "candidate_occupancy": float(cmax) / max(cap_c, 1),
            "pt_contacts_live": live_pt,
            "pt_contact_cap": cap_pt,
            "pt_contact_occupancy": live_pt / max(cap_pt, 1),
        })
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profile of the host and, where there is one, the card:
    ``with diagnostics.trace("prof"): ...`` writes a Chrome trace
    (``*.pt.trace.json``, for TensorBoard or Perfetto) into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


__all__ = ["KEYS", "broadphase_health", "constraint_residuals", "constraint_residuals_plain",
           "solver_stats", "trace"]
