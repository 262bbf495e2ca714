"""The port's domain decomposition (``pies_tpu_torch.parallel.domain``,
ROADMAP item 11a) against the JAX package's: the partitioner, the halo
stages (kernel T30's twins) and the contact-free scenes of
``tests/test_parallel.py`` (the rope in 2 slabs, 4 tet boxes in 4, 8
shape-matching boxes in 8).

* ``partition_domain`` equals the JAX one array for array on every scene
  of ``domain_cases.py``; ``halo=0`` on the rope raises.
* T30's refresh and reduce twins equal ``_halo_refresh`` and
  ``_halo_reduce`` under ``shard_map`` on 4 virtual devices, seeded
  arrays, k = 1, 3 and 4 (the JAX stages compiled once per shape, at k =
  4), with 2B <= L and 2B > L (where the reduce's order matters); the
  reduce's averaging modes and CG partials are its sum followed by the
  averaging and the block partials.
* Each scene starts both packages from one partition
  (``convert.domain_from_numpy``): one tick within 3e-6, or 3x the JAX
  package's own domain-against-single-device spread where that is larger,
  and 10 ticks within 3x that spread (3e-6 at least), the latch on the
  same tick (``domain_cases.py``; each JAX domain tick compiles once).
* Without JAX: the port's domain against the port's single scene over
  ``test_parallel.py``'s tick counts and bounds (one tick 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pies_tpu.parallel import domain as jdomain, ensemble as jens
from pies_tpu_torch import convert
from pies_tpu_torch.parallel import domain, halo

from domain_cases import (SCENES, build, check_against_jax, check_single, jax_scene, numpy_scene,
                          run_case)
from torch_threads import two_threads  # noqa: F401

FREE = ("rope", "tet_boxes", "shape_boxes")


def _jax_leaf(dom, path):
    obj = dom
    for name in path.split("."):
        obj = getattr(obj, name)
    return np.asarray(obj)


@pytest.mark.parametrize("name", list(SCENES))
def test_partition_matches_jax(name):
    s = jax_scene(name)
    state0, topo0, _, _, _ = numpy_scene(s)
    _, n_slabs, _, _, _, _, margin = SCENES[name]
    jdom = jdomain.partition_domain(state0, topo0, n_slabs=n_slabs, collision_margin=margin)
    pdom = domain.partition_domain(convert.state_from_numpy(state0),
                                   convert.topology_from_numpy(topo0), n_slabs,
                                   collision_margin=margin)
    assert (pdom.meta.n_slabs, pdom.meta.block, pdom.meta.halo) == (
        jdom.meta.n_slabs, jdom.meta.block, jdom.meta.halo)
    for key in domain.host_keys():
        a, b = pdom.host[key], _jax_leaf(jdom, key)
        assert a.shape == b.shape and a.dtype == b.dtype, key
        assert np.array_equal(a, b), key
    assert pdom.static.topo.floor_count.shape[0] == n_slabs * pdom.meta.view


def test_halo_zero_raises():
    s = jax_scene("rope")
    state0, topo0, _, _, _ = numpy_scene(s)
    with pytest.raises(ValueError):
        domain.partition_domain(convert.state_from_numpy(state0),
                                convert.topology_from_numpy(topo0), 2, halo=0)


@pytest.fixture(scope="module")
def halo_refs():
    """The JAX halo stages under ``shard_map`` on 4 virtual devices, once
    per shape on seeded k = 4 arrays (the stages act per component, so k =
    1 and 3 are their first components): ``{(block, halo): (own, view,
    refresh, reduce)}``."""
    mesh = jens.make_mesh(4, axis="x")
    out = {}
    for block, halo_w in ((16, 8), (16, 12)):
        meta = jdomain.DomainMeta(n_slabs=4, block=block, halo=halo_w)
        rng = np.random.default_rng(halo_w)
        own = rng.normal(size=(4, block, 4)).astype(np.float32)
        view = rng.normal(size=(4, meta.view, 4)).astype(np.float32)
        view[..., 3] = np.abs(view[..., 3]) * 2.0  # (counts for the averaged modes)
        out[block, halo_w] = (own, view,
                              np.asarray(_shard(mesh, lambda a: jdomain._halo_refresh(a, meta))(
                                  jnp.asarray(own))),
                              np.asarray(_shard(mesh, lambda a: jdomain._halo_reduce(a, meta))(
                                  jnp.asarray(view))))
    return out


def _shard(mesh, fn):
    return jax.jit(jax.shard_map(lambda a: fn(a[0])[None], mesh=mesh, in_specs=P("x"),
                                 out_specs=P("x"), check_vma=False))


def _first(a, k):
    """The first k components of a [..., 4] array ([...] for k = 1)."""
    return np.ascontiguousarray(a[..., 0] if k == 1 else a[..., :k])


@pytest.mark.parametrize("block,halo_w", [(16, 8), (16, 12)])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_halo_twins_match_shard_map(halo_refs, block, halo_w, k):
    """T30's twins against ``_halo_refresh`` and ``_halo_reduce`` under
    ``shard_map`` (2 x 12 > 16: the two bands overlap)."""
    own4, view4, ref4, red4 = halo_refs[block, halo_w]
    own, view, ref, red = (_first(a, k) for a in (own4, view4, ref4, red4))
    rng = np.random.default_rng(10 * k + halo_w)
    got = halo.refresh_plain(torch.from_numpy(own), halo_w)
    assert np.array_equal(got.numpy(), ref)
    summed = halo.reduce_plain(torch.from_numpy(view), halo_w)
    assert np.array_equal(summed.numpy(), red)
    embed = halo.refresh_plain(torch.from_numpy(own), halo_w, zero_halo=True).numpy()
    assert np.array_equal(embed[:, halo_w:halo_w + block], own)
    assert not embed[:, :halo_w].any() and not embed[:, halo_w + block:].any()
    if k == 4:  # the averaged apply of an accumulator (domain.py:889-892)
        avg = red[..., :3] / np.maximum(red[..., 3:], np.float32(1.0))
        got_avg = halo.reduce_plain(torch.from_numpy(view), halo_w, halo.AVERAGE).numpy()
        assert np.array_equal(got_avg, avg)
        x, prev = (torch.from_numpy(rng.normal(size=(4, block, 3)).astype(np.float32))
                   for _ in range(2))
        x0, prev0 = x.clone(), prev.clone()
        active = torch.from_numpy((rng.random((4, block)) < 0.3).astype(np.float32))
        stat = torch.from_numpy(rng.normal(size=(4, block, 3)).astype(np.float32))
        halo.reduce_plain(torch.from_numpy(view), halo_w, halo.APPLY, x_own=x, prev_own=prev,
                          active=active, stat=stat, failed=torch.zeros(2, dtype=torch.int32))
        assert torch.equal(prev, prev0 + torch.from_numpy(avg))
        assert torch.equal(x, torch.where(active[..., None] > 0, stat,
                                          x0 + torch.from_numpy(avg)))
    if k == 3:  # the CG's p.Ap partials over the owned nodes
        p = torch.from_numpy(rng.normal(size=(4, block, 3)).astype(np.float32))
        y, part = halo.reduce_plain(torch.from_numpy(view), halo_w, p=p)
        assert torch.equal(y, torch.from_numpy(red))
        dot = (p * y).sum(-1).reshape(-1).double().sum()
        assert abs(float(part.double().sum()) - float(dot)) < 1e-4


def test_merge_twins_keep_each_slab_prefix():
    """T30's gather of the slabs' contact lists: slab after slab, shifted
    by s·V, each slab's prefix kept up to the cap."""
    src = torch.arange(3 * 4 * 4, dtype=torch.int32).reshape(3, 4, 4) % 7
    mask = torch.ones(3, 4)
    counts = torch.tensor([[2], [4], [1]], dtype=torch.int32)
    idx, m, n = halo.merge_plain(src, mask, counts, 3, 10)
    assert int(n) == 2 + 3 + 1
    assert torch.equal(idx[:2], src[0, :2]) and torch.equal(idx[2:5], src[1, :3] + 10)
    assert torch.equal(idx[5], src[2, 0] + 20) and not idx[6:].any() and not m[6:].any()


@pytest.fixture(scope="module", params=FREE)
def case(request):
    return run_case(request.param)


def test_domain_tick_matches_jax(case):
    check_against_jax(case)


@pytest.mark.parametrize("name", FREE)
def test_domain_matches_the_single_scene(name):
    """The port's domain against its own single scene from the same state
    (``test_parallel.py``'s ticks and bounds, no JAX)."""
    check_single(name)


# ---------------------------------------------------------------------------
# the domain tick by the kernels on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SCENES))
def test_domain_kernels_equal_the_twins(cuda, name):
    """Two domain ticks by the kernels (T30, T3, T4, T9-T13, T16/T17 with
    the emit mask, T20, T25, T26, T27, T7, T8's accumulate-only mode, T11)
    bit-equal to the twins' on the card."""
    import pies_tpu_torch as pt
    from pies_tpu_torch.options import CollisionBudget
    from pies_tpu_torch.state import clone_state

    _, n_slabs, _, _, _, _, margin = SCENES[name]
    s = build(name, pt.Solver, pt.SolverOptions, CollisionBudget, device=cuda)
    doms = [domain.partition_domain(clone_state(s.state), s.topology, n_slabs,
                                    collision_margin=margin) for _ in range(2)]
    ticks = [domain.make_domain_tick(s.config, doms[0].meta, plain=p) for p in (False, True)]
    for _ in range(2):
        for dom, tick in zip(doms, ticks):
            tick(dom.state, dom.static, s.current_params())
    torch.cuda.synchronize()
    for f in ("positions", "prev_positions", "velocities", "shape_quats", "sim_failed"):
        assert torch.equal(getattr(doms[0].state, f), getattr(doms[1].state, f)), f
