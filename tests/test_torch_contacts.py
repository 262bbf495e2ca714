"""The port's point-triangle coupling and tail passes against the JAX
package, on a contact buffer with repeated nodes.

64 nodes carry 200 live contacts (a packed prefix of a 256-slot buffer, the
rest zero rows as the detection leaves them); every node is in several
contacts, in several columns.  Per node, the port sums in the order the JAX
package's CPU scatter adds (ascending column·cap + contact), so the
differences left are XLA's own rewrites on the CPU (FMA contraction, the
reciprocal for a division by a constant).  Tolerances: the diagonal and the
contact counts exactly (integers times 1e4); forces, stabilization and
friction sums 1e-5 relative to the largest entry (measured: force 0,
stabilization 9.0e-8, friction 1.1e-7).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pies_tpu.collision import batches as jbatches
from pies_tpu.options import SolverOptions as JOptions, make_params as jmake_params
from pies_tpu.solver import assembly as jassembly
from pies_tpu.solver import pd as jpd
from pies_tpu.solver import tetcols as jcols
import pies_tpu_torch as pt
from pies_tpu_torch.collision import batches as tbatches
from pies_tpu_torch.solver import assembly as tassembly
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import tetcols as tcols

N, CAP, LIVE = 64, 256, 200
REL = 1e-5
THICKNESS = 0.05


def _contacts(seed=0):
    rng = np.random.default_rng(seed)
    idx = np.zeros((CAP, 4), np.int32)
    for i in range(LIVE):
        idx[i] = rng.choice(N, 4, replace=False)
    mask = np.zeros(CAP, np.float32)
    mask[:LIVE] = 1.0
    x = rng.standard_normal((N, 3)).astype(np.float32)
    vel = rng.standard_normal((N, 3)).astype(np.float32)
    inv_mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    inv_mass[::9] = 0.0  # a few pinned nodes
    return idx, mask, x, vel, inv_mass


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jcolls(idx, mask):
    return dataclasses.replace(jbatches.empty_collision_set(pt_cap=CAP),
                               pt_idx=jnp.asarray(idx), pt_mask=jnp.asarray(mask))


def _tcolls(idx, mask):
    return tbatches.CollisionSet(floor_active=torch.zeros(N), pt_idx=_t(idx), pt_mask=_t(mask),
                                 pt_count=torch.tensor([LIVE], dtype=torch.int32))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * np.abs(ref).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_point_tri_diag_matches(seed):
    idx, mask, *_ = _contacts(seed)
    ref = jassembly.point_tri_collision_diag(_jcolls(idx, mask), N, jnp.float32)
    got = tassembly.point_tri_collision_diag(_t(idx), _t(mask), N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    inc = tbatches.incidence_plain(_t(idx), torch.tensor([LIVE], dtype=torch.int32), N)
    live = tassembly.point_tri_collision_diag(_t(idx), _t(mask), N, inc)
    np.testing.assert_array_equal(live.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_pt_force_matches(seed):
    idx, mask, x, *_ = _contacts(seed)
    k = N // 4
    kp = -(-k // 1024) * 1024
    xc = jcols.node3_to_cols(jnp.asarray(x))
    flat = jcols.pt_force_cols(xc, jcols._remap_corner_major(jnp.asarray(idx), kp),
                               jbatches.W_POINT_TRI * jnp.asarray(mask), jnp.sum(mask),
                               THICKNESS, k, kp, jnp.float32)
    ref = np.asarray(flat).reshape(4, 3, kp)[:, :, :k].transpose(2, 0, 1).reshape(N, 3)
    colls = _tcolls(idx, mask)
    inc = tbatches.incidence_plain(colls.pt_idx, colls.pt_count, N)
    got = tcols.pt_force_plain(_t(x), colls, inc, THICKNESS)
    _close(got.numpy(), ref)
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_stabilize_matches(seed):
    idx, mask, x, _, inv_mass = _contacts(seed)
    ref = np.asarray(jbatches.stabilize_point_tri_acc(
        jnp.asarray(x), jnp.asarray(inv_mass), jnp.asarray(idx), jnp.asarray(mask), THICKNESS))
    got = tbatches.stabilize_point_tri_acc(_t(x), _t(inv_mass), _t(idx), _t(mask), THICKNESS)
    np.testing.assert_array_equal(got.numpy()[:, 3], ref[:, 3])
    _close(got.numpy()[:, :3], ref[:, :3])
    assert ref[:, 3].max() >= 2  # nodes in several live contacts


@pytest.mark.parametrize("seed", [0, 1])
def test_friction_matches(seed):
    idx, mask, x, vel, inv_mass = _contacts(seed)
    jparams = jmake_params(JOptions(friction=0.3, static_friction_threshold=0.5))
    ref = np.asarray(jpd.point_tri_friction_acc(
        jnp.asarray(x), jnp.asarray(vel), jnp.asarray(inv_mass), jnp.asarray(idx),
        jnp.asarray(mask), jparams))
    params = pt.make_params(pt.SolverOptions(friction=0.3, static_friction_threshold=0.5))
    got = tpd.point_tri_friction_acc(_t(x), _t(vel), _t(inv_mass), _t(idx), _t(mask), params)
    np.testing.assert_array_equal(got.numpy()[:, 3], ref[:, 3])
    _close(got.numpy()[:, :3], ref[:, :3])


def test_incidence_orders_entries_like_the_scatter():
    """Each node's entries in ascending column·cap + contact: the order in
    which ``zeros.at[idx.T.reshape(-1)].add`` visits them."""
    idx, *_ = _contacts(2)
    inc = tbatches.incidence_plain(_t(idx), torch.tensor([LIVE], dtype=torch.int32), N)
    flat = idx.T.reshape(-1)
    live = (np.arange(4 * CAP) % CAP) < LIVE
    for n in range(N):
        want = np.nonzero((flat == n) & live)[0]
        got = inc.entries[inc.row_start[n]:inc.row_start[n + 1]].numpy()
        np.testing.assert_array_equal(got, want)
