"""The port's constraint residuals, stats and traces
(``pies_tpu_torch/diagnostics.py``: the plain twin of kernel T28) against
the JAX package, on the CPU; the broadphase's occupancy and health (T29)
are in ``tests/test_torch_occupancy.py``.

The states are the port's own ticks (its twins), fed to both packages: the
JAX function runs op by op (``jax.disable_jit``).  Under ``jax.jit`` XLA
on the CPU contracts products and sums into fused multiply-adds, and on
the bend sheet the dihedral angle's ``acos`` near a flat hinge amplifies
the contracted dot products' roundoff far past 1e-5; op by op the JAX
function rounds as written, and the port follows it.

* ``constraint_residuals`` on ``tests/test_diagnostics.py``'s sheet (80
  pins) and tet box, and a bend sheet (32 pins, 216 bends): every key
  within 1e-5 relative or 1e-7 absolute (measured: strain and volume equal,
  the rest within 2.4e-9 absolute).
* The strain's singular values are ``math3d.svd3x3``'s: its einsums are
  fused multiply-add chains (XLA's dot), where the ``_flat`` forms that T1
  copies round each product, and the two forms' σ differ (by more than
  100 ulps on some seeded F).  The port's σ is held within 4 float32 ulps
  of ``svd3x3``'s: PyTorch's square root on the CPU is not always
  correctly rounded, the card's and XLA's are.
* ``solver_stats`` has the JAX package's key set.

The ``gpu`` tests hold T28 to its twin on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu import diagnostics as jdiag
from pies_tpu.ops import math3d as jm3
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
import pies_tpu_torch as pt
from pies_tpu_torch import diagnostics as tdiag

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

RESIDUAL_SCENES = {
    "sheet": (lambda s: s.create_sheet((0.0, 8.0, 0.0), 1.0, 1.0, w=2000.0), 5),
    "tet_box": (lambda s: s.create_tet_box((0.0, 5.0, 0.0), 1.0, (0, 0, 0), w=2000.0,
                                           mass=1.0), 30),
    "bend_sheet": (lambda s: s.create_bend_sheet((0.0, 3.0, 0.0), 1.0, 1000.0), 20),
}


def _both(build, ticks, **kw):
    """The scene in both packages (the JAX solver only prepared), after
    ``ticks`` ticks of the port's twins; returns ``(jax_solver,
    port_solver)``."""
    j = pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0, **kw)
    t = pt.Solver(pt.SolverOptions(), device="cpu", **kw)
    build(j)
    build(t)
    j._prepare()
    t.run_ticks(ticks)
    return j, t


def _with_port_state(j, t, bp=None):
    """The JAX solver's state with the port's positions, previous positions
    and velocities, and ``bp`` as its cache."""
    st = t.state
    j._state = dataclasses.replace(
        j._state, positions=jnp.asarray(st.positions.numpy()),
        prev_positions=jnp.asarray(st.prev_positions.numpy()),
        velocities=jnp.asarray(st.velocities.numpy()), bp=bp)
    return j


@pytest.mark.parametrize("scene", list(RESIDUAL_SCENES))
def test_constraint_residuals_match_reference(scene):
    build, ticks = RESIDUAL_SCENES[scene]
    j, t = _both(build, ticks, enable_collisions=False)
    assert j._state.positions.shape == tuple(t.state.positions.shape)
    _with_port_state(j, t)
    with jax.disable_jit():
        ref = {k: float(v) for k, v in jdiag.constraint_residuals(j.state, j.topology).items()}
    ours = tdiag.constraint_residuals(t.state, t.topology)
    assert tuple(ours) == tdiag.KEYS and set(ours) == set(ref)
    for k, v in ours.items():
        assert v.shape == () and v.dtype == torch.float32
        assert abs(float(v) - ref[k]) <= max(1e-5 * abs(ref[k]), 1e-7), (k, float(v), ref[k])
    live = {"sheet": ("distance", "position", "max_speed"),
            "tet_box": ("strain", "volume", "max_speed"),
            "bend_sheet": ("distance", "position", "bend", "max_speed")}[scene]
    assert all(ref[k] > 0 for k in live), ref


def test_singular_values_follow_svd3x3():
    """The port's σ against ``svd3x3``'s op by op on seeded F (inverted
    ones among them): within 4 ulps, where the ``_flat`` form parts from
    ``svd3x3`` by far more."""
    rng = np.random.default_rng(3)
    f = (np.eye(3) + 0.3 * rng.standard_normal((2000, 3, 3))).astype(np.float32)
    f[:200, :, 2] *= -1.0
    with jax.disable_jit():
        ref = np.asarray(jm3.svd3x3(jnp.asarray(f))[1])
        flat = np.stack([np.asarray(s) for s in
                         jm3.svd3x3_flat(jm3.flatten3x3(jnp.asarray(f)))[1]], -1)
    ft = torch.from_numpy(f)
    ours = np.stack([s.numpy() for s in tdiag.singular_values(
        tuple(ft[:, i, k] for i in range(3) for k in range(3)))], -1)
    ulp = np.spacing(np.abs(ref))
    assert (np.abs(ours - ref) <= 4 * ulp).all(), float((np.abs(ours - ref) / ulp).max())
    assert (np.abs(flat - ref) > 100 * ulp).any()


def test_solver_stats_has_the_reference_keys():
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=False)
    t = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu")
    for s in (j, t):
        s.create_tet_box((0.0, 5.0, 0.0), 1.0, (0, 0, 0), w=2000.0, mass=1.0)
    s = t
    s.tick()
    stats = tdiag.solver_stats(s)
    with jax.disable_jit():
        ref = jdiag.solver_stats(j)
    assert set(stats) == set(ref)
    assert stats["ticks"] == 1 and stats["steps_per_sec"] > 0 and not stats["sim_failed"]


def test_trace_writes_a_profile(tmp_path):
    t = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu")
    t.create_tet_soup(8, spacing=1.6, scale=0.8, w=2000.0)
    with tdiag.trace(str(tmp_path)):
        t.tick()
    assert list(tmp_path.glob("*.pt.trace.json"))


# ---------------------------------------------------------------------------
# the kernels on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", list(RESIDUAL_SCENES))
def test_residual_kernel_equals_its_twin(cuda, scene):
    """T28 against its twin: every key bit-equal, bend (``acos``) within
    1e-6 relative."""
    build, ticks = RESIDUAL_SCENES[scene]
    t = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=cuda)
    build(t)
    t.run_ticks(ticks)
    launches = tdiag.constraint_residuals.launches
    k = tdiag.constraint_residuals(t.state, t.topology)
    p = tdiag.constraint_residuals_plain(t.state, t.topology)
    assert tdiag.constraint_residuals.launches == launches + 1
    for key in tdiag.KEYS:
        a, b = float(k[key]), float(p[key])
        assert a == b or (key == "bend" and abs(a - b) <= 1e-6 * abs(b)), (key, a, b)
