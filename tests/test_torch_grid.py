"""The port's uniform grid and body broadphase against the JAX package.

The grid functions are integer work on the same inputs, so they must agree
exactly: the cell hash (negative cells included), the sorted bucket table,
the queries with their caps and latches, and the gathered candidates.  The
body broadphase (the plain twin of kernel T5) is compared on states of a JAX
run of the 96-tet, spacing-1.0 soup: the cache it writes (pairs, valid
prefix, reference positions, freshness) and the capacity latch must be
equal, with the temporal cache and without it.  Pair slots past a row's
valid prefix are compared as 0 (the JAX package leaves sort leftovers there
that nothing reads; the port writes 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision import grid as jgrid
from pies_tpu.collision.broadphase import detect_point_tri_collisions as jdetect
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu_torch import convert
from pies_tpu_torch.collision import broadphase as tb
from pies_tpu_torch.collision import grid as tgrid

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

N_TETS = 96
SCENE = dict(spacing=1.0, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
TICKS = (0, 19, 25)


def _random_cells(rng, m, s, lo=-6, hi=6):
    return rng.integers(lo, hi, size=(m, s, 3)).astype(np.int32)


def _packed_table(table):
    """(start, count) of the JAX package's packed bucket table."""
    t = np.asarray(table)[:-1]
    return t & ((1 << 24) - 1), t >> 24


@pytest.mark.parametrize("n", [1, 7, 250, 4096, 250_000])
def test_table_size_matches(n):
    assert tgrid.table_size_for(n) == jgrid.table_size_for(n)


def test_cell_hash_matches_on_negative_cells():
    rng = np.random.default_rng(0)
    c = rng.integers(-(1 << 20), 1 << 20, size=(4096, 3)).astype(np.int32)
    c[:8] = [[-1, -1, -1], [0, 0, 0], [-(1 << 31), 5, 7], [(1 << 31) - 1, -3, 0],
             [-2, 3, -4], [1, -1, 1], [-100, 0, 100], [7, 7, -7]]
    ref = np.asarray(jgrid.cell_hash(*(jnp.asarray(c[:, d]) for d in range(3)))).astype(np.int64)
    got = tgrid.cell_hash(*(torch.from_numpy(c[:, d]) for d in range(3))).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense_buckets"])
def test_build_and_query_match(dense):
    """A dense case puts ~1,600 entries in 8 cells: buckets past the per-cell
    cap and the 127 saturation latch."""
    rng = np.random.default_rng(1 if dense else 2)
    m, s, h = 512, 4, 64
    cells = _random_cells(rng, m, s, *((0, 2) if dense else (-6, 6)))
    valid = rng.random((m, s)) < 0.8
    jg = jgrid.build_grid(jnp.asarray(cells), jnp.asarray(valid), h)
    tg = tgrid.build_grid(torch.from_numpy(cells), torch.from_numpy(valid), h)
    start, count = _packed_table(jg.bucket_table)
    np.testing.assert_array_equal(tg.start.numpy(), start)
    np.testing.assert_array_equal(np.minimum(tg.count.numpy(), 127), count)
    nv = int(valid.sum())
    np.testing.assert_array_equal(tg.sorted_items.numpy()[:nv], np.asarray(jg.sorted_items)[:nv])

    q = _random_cells(rng, m, 27, *((0, 2) if dense else (-7, 7)))
    qv = rng.random((m, 27)) < 0.9
    ref = jgrid.query_buckets(jg, jnp.asarray(q), jnp.asarray(qv), per_cell_cap=32)
    got = tgrid.query_buckets(tg, torch.from_numpy(q), torch.from_numpy(qv), per_cell_cap=32)
    for r, g in zip(ref[1:], got[1:]):  # offsets, total, overflow
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    live = np.asarray(ref[1]) > np.concatenate([np.zeros((m, 1), np.int32),
                                                 np.asarray(ref[1])[:, :-1]], axis=1)
    np.testing.assert_array_equal(got[0].numpy()[live], np.asarray(ref[0])[live])
    assert bool(np.asarray(ref[3]).any()) == dense

    cand_r, valid_r = jgrid.gather_entries(jg, *ref[:3], 24)
    cand_t, valid_t = tgrid.gather_entries(tg, *got[:3], 24)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_r))
    np.testing.assert_array_equal(cand_t.numpy()[valid_t.numpy()],
                                  np.asarray(cand_r)[np.asarray(valid_r)])


def test_aabb_cell_slots_match():
    rng = np.random.default_rng(3)
    lo = (rng.random((512, 3)) * 20 - 10).astype(np.float32)
    hi = lo + (rng.random((512, 3)) * 6).astype(np.float32)
    ref = jgrid.aabb_cell_slots(jnp.asarray(lo), jnp.asarray(hi), 32, 4)
    got = tgrid.aabb_cell_slots(torch.from_numpy(lo), torch.from_numpy(hi), 32, 4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    v = got[1].numpy()
    np.testing.assert_array_equal(got[0].numpy()[v], np.asarray(ref[0])[v])


@pytest.fixture(scope="module")
def reference_run():
    """States of the 96-tet, spacing-1.0 soup at ticks 0, 19 and 25 of a JAX
    run, each with the predicted positions its detection sees."""
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=True, dense_operator_max=0)
    j.create_tet_soup(N_TETS, **SCENE)
    j._prepare()
    params, cfg = j.current_params(), j._config
    states = {}
    for tick in range(max(TICKS) + 1):
        if tick in TICKS:
            s = j._state
            x = s.positions + params.dt * s.velocities * s.node_mask[:, None]
            states[tick] = (x, s)
        j.tick()
    det = jax.jit(lambda x, p, c: jdetect(x, p, j._topology.triangles, j._topology.tri_mask,
                                          params, cfg, cache=c))
    det_free = jax.jit(lambda x, p: jdetect(x, p, j._topology.triangles, j._topology.tri_mask,
                                            params, cfg))
    return j, states, det, det_free


def _port_detect(j, x, s, cached):
    cfg = convert.config_from(j._config)
    params = convert.params_from(jax.tree.map(np.asarray, j.current_params()))
    cache = convert.cache_from_numpy(jax.tree.map(np.asarray, s.bp)) if cached else None
    out = tb.detect_point_tri_collisions(
        torch.from_numpy(np.array(x)), torch.from_numpy(np.array(s.prev_positions)),
        torch.from_numpy(np.array(j._topology.tri_mask)), params, cfg, cache=cache)
    return out, cache


@pytest.mark.parametrize("cached", [True, False], ids=["cache", "no_cache"])
@pytest.mark.parametrize("tick", TICKS)
def test_body_broadphase_matches_reference(reference_run, tick, cached):
    j, states, det, det_free = reference_run
    x, s = states[tick]
    out, cache = _port_detect(j, x, s, cached)
    if cached:
        _, _, over, new = det(x, s.prev_positions, s.bp)
        ref = convert.cache_from_numpy(jax.tree.map(np.asarray, new))
        for f in ("pairs", "valid", "ref", "fresh"):
            assert torch.equal(getattr(cache, f), getattr(ref, f)), f
        assert int(cache.valid.sum()) > 0
    else:
        _, _, over = det_free(x, s.prev_positions)
    assert int(out[3][0]) == int(bool(over))


def test_dense_soup_latches_like_reference():
    """A single narrow slot per body overflows the exact tier at once: both
    packages latch on the first detection."""
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=True, dense_operator_max=0,
                        budget_overrides={"max_narrow_bodies": 1})
    j.create_tet_soup(64, **dict(SCENE, spacing=0.9))
    j._prepare()
    s, params = j._state, j.current_params()
    x = s.positions + params.dt * s.velocities * s.node_mask[:, None]
    _, _, over, _ = jdetect(x, s.prev_positions, j._topology.triangles, j._topology.tri_mask,
                            params, j._config, cache=s.bp)
    out, _ = _port_detect(j, x, s, True)
    assert bool(over) and int(out[3][0]) == 1
