"""The port's domain decomposition with edge-edge and PD node-node
contacts (ROADMAP item 11a) against the JAX package's: the crossing
strips of ``tests/test_parallel.py`` (margin 2.5,
``reference_quirks=False``) and the line of spheres (margin 4.0, a budget
of 512 pairs), each in 2 slabs; the checks of
``test_torch_domain_contacts.py`` (``domain_cases.py``), with T25 and T20
(each with its emit mask) as the detection, and ``test_parallel.py``'s
ticks and bounds (10 ticks, 1e-3; 15 ticks, 1e-3) for the port's domain
against its own single scene."""

import pytest

from domain_cases import check_against_jax, check_single, check_slab_sets, run_case
from torch_threads import two_threads  # noqa: F401

SCENES = ("edge_strips", "node_line")


@pytest.fixture(scope="module", params=SCENES)
def case(request):
    return run_case(request.param)


def test_domain_tick_matches_jax(case):
    check_against_jax(case)


def test_slab_contact_sets_match_jax_and_cover_each_contact_once(case):
    check_slab_sets(case)


@pytest.mark.parametrize("name", SCENES)
def test_domain_matches_the_single_scene(name):
    check_single(name)
