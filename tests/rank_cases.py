"""The rank side of ``tests/test_torch_ranks.py``: what each gloo rank runs.

This module imports no JAX and nothing of the JAX package (``domain_cases``
does), so that a rank process holds only the port: :func:`worker` checks
its own ``sys.modules``.  The parent hands the cases over in one file
(``torch.save``: the port's states, topologies and the partitions' NumPy
host arrays), every rank runs every case, and each returns its results.

* ``ensemble``: the rope ensemble sharded over the ranks
  (``shard_ensemble``, ``make_sharded_step``, ``gather_ensemble``) beside
  the one-process ``ensemble_step`` of all B members.
* ``domain``: the rank's slabs of a partition (``shard_host``) ticked over
  the ranks, the whole domain's positions gathered after every tick, a
  rerun from the same partition, and T30's outer-band modes (the exchange
  and the band twins) against the one-device refresh and reduce of all the
  slabs, on seeded arrays at the scene's shapes.
* ``latch``: a NaN put into one rank's slab; every rank's latch after the
  tick.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

FIELDS = ("positions", "prev_positions", "velocities", "shape_quats")


def ensemble_case(mesh, c):
    from pies_tpu_torch.parallel import ensemble
    from pies_tpu_torch.state import clone_state

    full, topo, params, cfg = c["states"], c["topo"], c["params"], c["config"]
    mine = ensemble.shard_ensemble(full, mesh)
    full = clone_state(full)
    step = ensemble.make_sharded_step(mesh, cfg)
    diag, one = [], []
    for _ in range(c["ticks"]):
        _, res, failed = step(mine, topo, params)
        diag.append((float(res), int(failed)))
        res1, failed1 = ensemble.ensemble_step(full, topo, params, cfg)
        one.append((float(res1), int(failed1)))
    back = ensemble.gather_ensemble(mine, mesh)
    return dict(diag=diag, one=one, positions=back.positions.numpy(),
                one_positions=full.positions.numpy(),
                equal=all(torch.equal(getattr(back, f), getattr(full, f))
                          for f in ("positions", "prev_positions", "velocities",
                                    "sim_failed")))


def band_checks(mesh, meta, seed):
    """T30's outer-band modes on this rank's slabs of seeded arrays,
    exchanged with the neighbouring ranks, against the same stages over all
    the slabs on one device (bit for bit; the p·Ap partials' total within
    1e-5 of the float64 dot, since the rank's blocks start at its own
    first node)."""
    from pies_tpu_torch.parallel import halo
    from pies_tpu_torch.parallel.ranks import Transport

    d, l, b = meta.n_slabs, meta.block, meta.halo
    v = l + 2 * b
    net = Transport(mesh)
    mine = mesh.share(d, "slabs")
    rng = np.random.default_rng(seed)
    own = torch.from_numpy(rng.normal(size=(d, l, 4)).astype(np.float32))
    view = torch.from_numpy(rng.normal(size=(d, v, 4)).astype(np.float32))
    view[..., 3] = view[..., 3].abs() * 2.0
    p = torch.from_numpy(rng.normal(size=(d, l, 3)).astype(np.float32))
    x, prev, stat = (torch.from_numpy(rng.normal(size=(d, l, 3)).astype(np.float32))
                     for _ in range(3))
    active = torch.from_numpy((rng.random((d, l)) < 0.3).astype(np.float32))
    ok = {}
    for k in (1, 3, 4):
        o = own[..., 0] if k == 1 else own[..., :k].contiguous()
        w = view[..., 0] if k == 1 else view[..., :k].contiguous()
        om, wm = o[mine].contiguous(), w[mine].contiguous()
        bands = net.exchange(om[0, :b], om[-1, l - b:])
        ok[f"refresh k={k}"] = torch.equal(halo.refresh(om, b, False, *bands),
                                           halo.refresh_plain(o, b)[mine])
        bands = net.exchange(wm[0, :b], wm[-1, v - b:])
        ok[f"reduce k={k}"] = torch.equal(halo.reduce(wm, b, left=bands[0], right=bands[1]),
                                          halo.reduce_plain(w, b)[mine])
        if k == 3:
            y, part = halo.reduce(wm, b, p=p[mine].contiguous(), left=bands[0],
                                  right=bands[1])
            y1 = halo.reduce_plain(w, b)
            total = float(net.gather(part).double().sum())
            dot = float((p.double() * y1.double()).sum())
            ok["reduce p.Ap"] = torch.equal(y, y1[mine]) and abs(total - dot) <= 1e-5 * max(
                1.0, abs(dot))
        if k == 4:
            ok["average"] = torch.equal(
                halo.reduce(wm, b, halo.AVERAGE, left=bands[0], right=bands[1]),
                halo.reduce_plain(w, b, halo.AVERAGE)[mine])
            xa, pa = x[mine].clone(), prev[mine].clone()
            xb, pb = x.clone(), prev.clone()
            failed = torch.zeros(2, dtype=torch.int32)
            halo.reduce(wm, b, halo.APPLY, x_own=xa, prev_own=pa,
                        active=active[mine].contiguous(), stat=stat[mine].contiguous(),
                        failed=failed, left=bands[0], right=bands[1])
            halo.reduce_plain(w, b, halo.APPLY, x_own=xb, prev_own=pb, active=active, stat=stat,
                              failed=failed)
            ok["apply"] = torch.equal(xa, xb[mine]) and torch.equal(pa, pb[mine])
    return ok


def domain_case(mesh, c):
    from pies_tpu_torch.parallel import domain

    host, meta, params, cfg, n_live = c["host"], c["meta"], c["params"], c["config"], c["n_live"]
    dom = domain.shard_host(host, meta, mesh)
    tick = domain.make_domain_tick(cfg, meta, mesh=mesh)
    traj, latch = [], []
    for _ in range(c["ticks"]):
        tick(dom.state, dom.static, params)
        traj.append(domain.gather_positions(dom, dom.state, mesh)[:n_live])
        latch.append(bool(dom.state.sim_failed.any()))
    again = domain.shard_host(host, meta, mesh)
    rerun = []
    for t in range(c["rerun"]):
        tick(again.state, again.static, params)
        rerun.append(domain.gather_positions(again, again.state, mesh)[:n_live])
    out = dict(traj=np.stack(traj), latch=latch,
               rerun=all(np.array_equal(a, b) for a, b in zip(rerun, traj)),
               local=tuple(dom.state.positions.shape))
    out["bands"] = band_checks(mesh, meta, c["seed"])
    if c.get("wide") is not None:  # the bands wider than half a block (2B > L)
        out["bands"].update({f"{k} (2B > L)": v
                             for k, v in band_checks(mesh, c["wide"], c["seed"] + 1).items()})
    return out


def latch_case(mesh, c):
    """A NaN in one node of the rank ``c["nan_rank"]``'s first slab: every
    rank's latch after one tick."""
    from pies_tpu_torch.parallel import domain

    dom = domain.shard_host(c["host"], c["meta"], mesh)
    tick = domain.make_domain_tick(c["config"], c["meta"], mesh=mesh)
    before = bool(dom.state.sim_failed.any())
    if mesh.rank == c["nan_rank"]:
        dom.state.positions[0, c["node"], 0] = float("nan")
    tick(dom.state, dom.static, c["params"])
    return dict(before=before, after=bool(dom.state.sim_failed.any()))


CASES = dict(ensemble=ensemble_case, domain=domain_case, latch=latch_case)


def worker(path):
    """One rank: every case of the file ``path`` (``{name: case}``, each
    with its ``kind``), one torch thread; returns ``{name: result}`` and
    whether the process imported JAX or the JAX package."""
    from pies_tpu_torch.parallel import ranks

    torch.set_num_threads(1)
    mesh = ranks.make_mesh(device="cpu")
    cases = torch.load(path, weights_only=False)
    out = {name: CASES[c["kind"]](mesh, c) for name, c in cases.items()}
    out["imports"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith(("jax.", "pies_tpu.")) or m == "pies_tpu")
    out["rank"] = mesh.rank
    return out
