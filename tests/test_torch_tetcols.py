"""The port's tet-column PD iteration (kernel T2 and its twin) and topology
against the JAX package, on identical inputs.

The scene is a 96-tet soup in a node capacity of 400, so the last 4 blocks
are padding (parked nodes, zero off-diagonals, zero tet force); some nodes
are pushed below the floor so the floor term is active.  Tolerances:
positions 2e-5 absolute (a few float32 ulps at |x| ≈ 7 after 4 iterations
whose right-hand side is ~4e4 — the JAX package fuses multiply-adds, the
port does not); the block factor and solve 1e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision.batches import empty_collision_set
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.solver import tetcols as jcols
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.constraints.projections import (corner_cols, tet_force12,
                                                     tet_force12_fused_cols)
from pies_tpu_torch.solver import tetcols as tcols

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

N_TETS, CAP = 96, 400
POS_TOL = 2e-5


def _solvers(pins):
    def scene(s):
        s.create_tet_soup(N_TETS, spacing=1.6, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
        if pins:
            s._builder.pos_idx.append(np.asarray(pins, np.int32))
            s._builder.pos_w.append(np.full(len(pins), 8000.0, np.float32))
        s._prepare()
        return s

    j = scene(pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=False,
                              dense_operator_max=0, node_capacity=CAP))
    t = scene(pt.Solver(pt.SolverOptions(), enable_collisions=False, node_capacity=CAP,
                        device="cpu"))
    return j, t


def _inputs(j):
    """Seeded substep inputs in numpy: predicted x with some nodes below the
    floor, Ms/h², the system diagonal and the floor weight."""
    st, topo = j._state, j._topology
    rng = np.random.default_rng(5)
    x = np.array(st.positions)
    n_live = 4 * N_TETS
    x[:n_live] += 0.02 * rng.standard_normal((n_live, 3)).astype(np.float32)
    low = rng.choice(n_live, 40, replace=False)
    x[low, 1] = -0.02
    h = np.float32(0.012)
    mass = np.asarray(st.mass)
    moh2 = mass / (h * h)
    fc = np.asarray(topo.floor_count)
    active = ((x[:, 1] < np.float32(0.05)) & (fc > 0)).astype(np.float32)
    wf = np.float32(1e4) * fc * active
    diag = moh2 + np.asarray(topo.stiffness_diag) + wf
    msn = x * moh2[:, None]
    return x, msn, diag, active, wf


@pytest.mark.parametrize("pins", [None, [0, 5]], ids=["free", "pinned"])
def test_substep_cols_matches_reference(pins):
    j, t = _solvers(pins)
    x, msn, diag, active, wf = _inputs(j)
    assert active.sum() >= 40 and np.asarray(j._state.node_mask).sum() < CAP
    colls = dataclasses.replace(
        empty_collision_set(pt_cap=0, static_cap=0), floor_active=jnp.asarray(active)
    )
    cfg, params = j._config, j.current_params()
    assert jcols.applies(j._state, j._topology, colls, cfg, None)
    jx, jstatic, jres = jax.jit(
        lambda x, msn, diag: jcols.substep_cols(
            x, msn, diag, None, j._state.node_mask, j._topology, colls, params, cfg
        )
    )(x, msn, diag)

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    tx, tstatic, r2 = tcols.substep_cols(
        T(x), T(msn), T(diag), t.state.node_mask, T(wf), t.topology, 0.0, 4
    )
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=POS_TOL)
    np.testing.assert_allclose(tstatic.numpy(), np.asarray(jstatic), atol=POS_TOL)
    # Padding nodes stay exactly parked.
    np.testing.assert_array_equal(tx.numpy()[4 * N_TETS:], x[4 * N_TETS:])
    assert np.all(tstatic.numpy()[:, 1] >= 0.0)
    # A direct solve leaves only roundoff of the right-hand side in the
    # residual; both packages' residuals are that small.
    b_norm = float(np.linalg.norm(msn[: 4 * N_TETS]))
    res = float(torch.sqrt(r2.sum()))
    assert res < 1e-6 * b_norm and float(jres) < 1e-6 * b_norm, (res, float(jres))


def test_first_force_from_t1_changes_nothing():
    """T2 computes its first iteration's tet force itself, from the
    predicted positions in its corner columns: T1's force on the same
    positions is that force bit for bit, so the tet-column path needs no
    T1 launch beside T2."""
    j, t = _solvers(None)
    x, _, _, _, _ = _inputs(j)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    topo = t.topology
    f0 = tet_force12(T(x), topo.strain, topo.volume)
    c = topo.strain.qinv.shape[1]
    cols = corner_cols(T(x), x.shape[0] // 4)
    inside = tet_force12_fused_cols([[cols[a][d][:c] for d in range(3)] for a in range(4)],
                                    topo.strain, topo.volume)
    assert f0.shape == (12, c) and float(f0.abs().max()) > 0.0
    assert torch.equal(torch.stack(list(inside)), f0)


def test_block_factor_and_solve_match_reference():
    rng = np.random.default_rng(11)
    k = 64
    block6 = (100.0 * rng.standard_normal((6, k))).astype(np.float32)
    d = (5000.0 + 1000.0 * rng.random((4, k))).astype(np.float32)  # SPD
    r = (1e4 * rng.standard_normal((4, 3, k))).astype(np.float32)
    jf = jcols.block_factor_cols(tuple(jnp.asarray(v) for v in d), jnp.asarray(block6))
    tf = tcols.block_factor_cols(tuple(torch.from_numpy(v) for v in d), torch.from_numpy(block6))
    for a, b in zip(jf, tf):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    jz = jcols.block_solve_cols(jf, tuple(tuple(jnp.asarray(r[a, e]) for e in range(3)) for a in range(4)))
    tz = tcols.block_solve_cols(tf, tuple(tuple(torch.from_numpy(r[a, e]) for e in range(3)) for a in range(4)))
    for a in range(4):
        for e in range(3):
            np.testing.assert_allclose(tz[a][e].numpy(), np.asarray(jz[a][e]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pins", [None, [0, 5]], ids=["free", "pinned"])
def test_topology_matches_reference(pins):
    """The port's host builders give the JAX package's topology exactly, and
    the converter carries the JAX one across unchanged."""
    j, t = _solvers(pins)
    jt = jax.tree.map(np.asarray, j._topology)
    carried = convert.topology_from_numpy(jt)
    for topo in (t.topology, carried):
        for f in ("stiffness_diag", "floor_count", "tet_block6", "position_force_dense"):
            np.testing.assert_array_equal(getattr(topo, f).numpy(), getattr(jt, f), err_msg=f)
        for b in ("strain", "volume"):
            for f in ("qinv", "g", "lo", "hi", "w"):
                np.testing.assert_array_equal(
                    getattr(getattr(topo, b), f).numpy(), getattr(getattr(jt, b), f)
                )
