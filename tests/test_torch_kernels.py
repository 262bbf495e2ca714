"""The port's CUDA kernels against their plain PyTorch twins.

This file imports nothing of JAX or of the JAX package; on a GPU machine:

    python -m pytest -m gpu tests/test_torch_kernels.py -q

Tests marked ``gpu`` skip without a CUDA device.  The library is built with
``-fmad=false`` and IEEE division and square root, and each kernel does its
twin's float32 operations in the same order, so the tolerances are tight: T3
and T4 exact, T1 1e-6 of the largest force and T2 1e-6 absolute (allowing
only for library-math differences), and a 40-tick trajectory 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pies_tpu_torch as pt
from pies_tpu_torch.constraints import projections as proj
from pies_tpu_torch.solver import pd, step, tetcols

SCENE = dict(spacing=1.6, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
WRAPPERS = (pd.substep_head, proj.tet_force12, tetcols.substep_cols, pd.substep_tail)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _solver(device, n=96):
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=device)
    s.create_tet_soup(n, **SCENE)
    return s


def _clone(state):
    return dataclasses.replace(
        state, **{f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)}
    )


def _head_inputs(s):
    """A state whose predicted positions put the bottom layer on the floor."""
    st = s.state
    rng = np.random.default_rng(0)
    vel = 0.5 * rng.standard_normal((st.capacity, 3)) + np.array([0.0, -40.0, 0.0])
    st.velocities.copy_(torch.from_numpy(vel.astype(np.float32)).to(st.device)
                        * st.node_mask[:, None])
    return st, s.topology, s._config, s.current_params()


def test_cpu_tensors_take_the_twin_and_count_nothing():
    s = _solver("cpu")
    before = [f.launches for f in WRAPPERS]
    s.run_ticks(2)
    assert [f.launches for f in WRAPPERS] == before
    assert not s.sim_failed


def test_cuda_solver_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Solver(pt.SolverOptions(), enable_collisions=False)


@pytest.mark.gpu
def test_head_and_tail_kernels_are_exact(cuda):
    s = _solver(cuda)
    st, topo, cfg, params = _head_inputs(s)
    a, b = _clone(st), _clone(st)
    hk = pd.substep_head(a, topo, params, cfg, True)
    hp = pd.substep_head_plain(b, topo, params, cfg, True)
    for u, v in zip(hk, hp):
        assert torch.equal(u, v)
    assert hk[4].sum().item() > 0  # floor-active nodes
    x, static, _ = tetcols.substep_cols(hk[0], hk[1], hk[2], st.node_mask, hk[3], None, topo,
                                        0.0, cfg.iterations, st.sim_failed)
    pd.substep_tail(a, topo, params, hk[4], x, static)
    pd.substep_tail_plain(b, topo, params, hk[4], x, static)
    for f in ("positions", "prev_positions", "velocities", "forces", "sim_failed"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.gpu
def test_tet_force12_kernel_matches_twin(cuda):
    s = _solver(cuda, n=1024)
    st, topo, cfg, params = _head_inputs(s)
    x = pd.substep_head_plain(_clone(st), topo, params, cfg, True)[0]
    out = proj.tet_force12(x, topo.strain, topo.volume, st.sim_failed)
    ref = proj.tet_force12_plain(x, topo.strain, topo.volume)
    assert (out - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("pins", [None, [0, 5]], ids=["soup", "pinned_soup"])
def test_substep_cols_kernel_matches_twin(cuda, pins):
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=cuda, node_capacity=4112)
    s.create_tet_soup(1024, **SCENE)  # 4 padding blocks past the live tets
    if pins:
        s._builder.pos_idx.append(np.asarray(pins, np.int32))
        s._builder.pos_w.append(np.full(len(pins), 8000.0, np.float32))
    st, topo, cfg, params = _head_inputs(s)
    x, msn, diag, wf, _ = pd.substep_head_plain(_clone(st), topo, params, cfg, True)
    f0 = proj.tet_force12_plain(x, topo.strain, topo.volume)
    args = (x, msn, diag, st.node_mask, wf, f0, topo, 0.0, cfg.iterations, st.sim_failed)
    out = tetcols.substep_cols(*args)
    ref = tetcols.substep_cols_plain(*args)
    for u, v in zip(out[:2], ref[:2]):
        assert (u - v).abs().max().item() <= 1e-6
    assert torch.equal(out[0][4 * 1024:], x[4 * 1024:])  # padding stays parked


@pytest.mark.gpu
def test_kernels_match_twins_over_a_trajectory(cuda):
    before = [f.launches for f in WRAPPERS]
    a, b = _solver(cuda), _solver(cuda)
    a.run_ticks(40)
    step.tick_n(b.state, b.topology, b.current_params(), b._config, 40, plain=True)
    assert [f.launches - n for f, n in zip(WRAPPERS, before)] == [40] * 4
    assert not a.sim_failed and not b.sim_failed
    assert (a.state.positions - b.state.positions).abs().max().item() <= 1e-5
    assert a.state.positions[:, 1].min().item() < 0.05


@pytest.mark.gpu
def test_failure_latch_on_the_card(cuda):
    """A non-finite position latches on the card and freezes the state,
    with no host sync inside run_ticks."""
    s = _solver(cuda, n=24)
    s.state.velocities[7, 0] = float("inf")
    s.run_ticks(1)
    assert s.sim_failed
    frozen = s.state.positions.clone()
    s.run_ticks(3)
    torch.testing.assert_close(s.state.positions, frozen, rtol=0, atol=0, equal_nan=True)
    assert s.last_residual == 0.0


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    s = _solver(cuda, n=24)
    topo = s.topology
    with pytest.raises(ValueError):
        proj.tet_force12(s.state.positions.double(), topo.strain, topo.volume)
    with pytest.raises(ValueError):
        proj.tet_force12(s.state.positions.t().contiguous().t(), topo.strain, topo.volume)
