"""Full contact coupling and the disjoint-tet block preconditioner of the
port (the plain twins of kernels T22 and T23) against the JAX package, on
the CPU, on the soups of ``tests/coupling_scenes.py``: ``soup_full`` (24
tets at spacing 1.0, ``contact_coupling="full"``) and ``soup_block`` (the
same soup with ``tet_cols=False``); the box with the entry-list floor and
the sheet over a soup with full coupling are in
``tests/test_torch_coupling_scenes.py``.

Tolerances and why:

* T22's factor and solve against ``tet_block_factor``/``tet_block_apply``
  and a float64 dense solve: 1e-6 relative (the JAX package's rsqrt rounds
  once, the port's ``1/sqrt`` twice);
* the PCG with the block preconditioner (and full coupling) against the JAX
  ``pcg_solve`` with ``precond_fn``: x within 1e-6, the trip count equal
  (the JAX count read off its trip cap: the least cap whose solve equals
  the uncapped one); one trip with the exact preconditioner of recentered
  coupling;
* the operator with full coupling against ``apply_system``: 1e-6 of the
  largest entry (the contacts' terms are summed per node in another
  order);
* the stack form of ``project_point_tri``: equal;
* one tick from the JAX state: 3e-6, the contact sets equal as sets; 40
  ticks: ``coupling_scenes.RUN_TOL``, from the JAX package's own float32
  spread, the latch on the same ticks.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pies_tpu.collision import batches as jbatches
from pies_tpu.solver import assembly as jasm
import pies_tpu_torch as pt
from pies_tpu_torch.collision import batches as tbatches
from pies_tpu_torch.solver import assembly as tasm
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import tetcols as ttetcols

from coupling_scenes import (
    _soup,
    forty_ticks_match,
    jax_run,
    one_tick_matches,
    operator_matches,
    port_solver,
    system,
)
from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

SOUPS = ["soup_full", "soup_block"]


def _system(scene):
    # Both soups share one JAX detection compile (it reads no coupling field).
    return system(scene, jax_run("soup_full")[2][3])


def test_soups_take_the_generic_path_with_the_block_preconditioner():
    """Full coupling and ``tet_cols=False`` move the soup off the tet-column
    path and keep its block layout (a band, an ELL of width 0, the row
    incidence); the default soup stays on the tet-column path."""
    for scene in SOUPS:
        t = port_solver(scene)
        assert not ttetcols.applies(t.state, t.topology, t.config), scene
        assert tpd.block_layout(t.state, t.topology), scene
        assert t.topology.tet_band is not None and t.topology.ell_nbr.shape[0] == 0
        assert t.topology.row_inc is not None
    t = pt.Solver(pt.SolverOptions(), device="cpu")
    _soup(t)._prepare()
    assert ttetcols.applies(t.state, t.topology, t.config)


def _blocks(k=9, seed=3):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(k, 4, 4)).astype(np.float32)
    blocks = np.einsum("kab,kcb->kac", g, g) + 3.0 * np.eye(4, dtype=np.float32)[None]
    diag = np.ascontiguousarray(np.einsum("kaa->ka", blocks)).reshape(-1)
    b6 = np.stack([blocks[:, a, b] for a, b in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3),
                                                 (2, 3))])
    r = rng.normal(size=(4 * k, 3)).astype(np.float32)
    return blocks, diag, b6, r


def test_tet_block_twin_matches_jax_and_a_dense_solve():
    blocks, diag, b6, r = _blocks()
    jf = jasm.tet_block_factor(jnp.asarray(diag), jnp.asarray(b6))
    jz = np.asarray(jasm.tet_block_apply(jf, jnp.asarray(r)))
    f = tasm.tet_block_factor_plain(torch.from_numpy(diag), torch.from_numpy(b6))
    z = tasm.tet_block_apply_plain(f, torch.from_numpy(r)).numpy()
    jf = np.stack([np.asarray(c) for c in jf])
    assert np.abs(f.numpy() - jf).max() <= 1e-6 * np.abs(jf).max()
    assert np.abs(z - jz).max() <= 1e-6 * np.abs(jz).max()
    ref = np.stack([np.linalg.solve(blocks[i].astype(np.float64), r[4 * i:4 * i + 4])
                    for i in range(blocks.shape[0])]).reshape(-1, 3)
    assert np.abs(z - ref).max() <= 1e-6 * np.abs(ref).max()


def test_full_coupling_operator():
    """T23's operator term (in T10's twin) against the JAX
    ``apply_system(contact_coupling="full")`` on the soup with live
    contacts."""
    operator_matches(_system("soup_full"))


def _jax_trips(solve, b, x0, cap):
    """The trips the JAX ``pcg_solve`` runs: the least cap at which it
    equals the solve capped at ``cap``."""
    full = np.asarray(solve(b, x0, cap))
    for k in range(cap + 1):
        if np.array_equal(np.asarray(solve(b, x0, k)), full):
            return k, full
    raise AssertionError("no trip count reproduces the solve")


@pytest.mark.parametrize("scene", SOUPS)
def test_block_pcg_matches_jax(scene):
    """``pcg_solve_plain`` with the block preconditioner (T22's factor; with
    full coupling T23's operator) against the JAX ``pcg_solve`` with
    ``precond_fn``, on a seeded right-hand side at the predicted
    positions: x within 1e-6, the trip count equal."""
    sy = _system(scene)
    rng = np.random.default_rng(5)
    x0 = np.asarray(sy["x"])
    b = np.asarray(sy["matvec"](jnp.asarray(x0))) + rng.normal(
        0.0, 10.0, x0.shape).astype(np.float32)
    precond = partial(jasm.tet_block_apply,
                      jasm.tet_block_factor(sy["diag"], sy["topo"].tet_block6))

    @jax.jit
    def jsolve(bb, xx, cap):
        return jasm.pcg_solve(sy["matvec"], bb, xx, sy["diag"], cap, rtol=1e-4,
                              precond_fn=precond)[0]

    trips, ref = _jax_trips(lambda bb, xx, cap: jsolve(jnp.asarray(bb), jnp.asarray(xx),
                                                       jnp.int32(cap)), b, x0, 16)
    tst, ttopo = sy["tst"], sy["ttopo"]
    diag = torch.from_numpy(np.array(sy["diag"]))
    block = tasm.tet_block_factor_plain(diag, ttopo.tet_block6)
    full = sy["full"] if scene == "soup_full" else None
    x, _, got = tasm.pcg_solve_plain(torch.from_numpy(b), torch.from_numpy(x0.copy()), diag,
                                     tst.mass, torch.from_numpy(np.array(sy["static_diag"])),
                                     sy["h2"], torch.ones_like(tst.mass), ttopo, 16, 1e-4,
                                     None, block, full)
    assert int(got[0]) == trips
    assert trips == 1 if scene == "soup_block" else trips > 1
    assert np.abs(x.numpy() - ref).max() <= 1e-6


def test_stack_projection_equals_jax():
    """The stack form of ``project_point_tri`` on the soup's live contacts
    at the predicted positions: equal to the JAX function."""
    sy = _system("soup_full")
    c, thick = sy["colls"], sy["tparams"].collision_thickness
    # Op by op: under jax.jit XLA contracts and reorders its roundings.
    ref, _ = jbatches.project_point_tri(sy["x"], c.pt_idx, thick, build_stack=True)
    got = tbatches.project_point_tri(torch.from_numpy(np.array(sy["x"])),
                                     torch.from_numpy(np.array(c.pt_idx)), thick)
    live = sy["live"]
    assert live > 0
    np.testing.assert_array_equal(got[:live].numpy(), np.asarray(ref)[:live])


@pytest.mark.parametrize("scene", SOUPS)
def test_one_tick_from_the_jax_state(scene):
    one_tick_matches(scene, jax_run("soup_full")[2][3])


@pytest.mark.parametrize("scene", SOUPS)
def test_forty_ticks_match_reference(scene):
    forty_ticks_match(scene)
