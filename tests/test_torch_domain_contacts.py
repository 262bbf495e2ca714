"""The port's domain decomposition with point-triangle self-contact
(ROADMAP item 11a) against the JAX package's: the two-slab tet-box pile of
``tests/test_parallel.py`` (margin 1.3); the edge-edge and node-node scenes
are ``test_torch_domain_edges.py``'s (one file each, so that a parallel
test run spreads the JAX compiles).

* Both packages start from one partition (``convert.domain_from_numpy``):
  one tick within 3e-6, or 3x the JAX package's own domain-against-single
  spread where that is larger, and 10 ticks within 3x that spread (3e-6
  at least), the latch on the same tick (``domain_cases.py``).
* Each slab's contacts on identical inputs (the first substep's predicted
  views): the port's detection with its emit mask (the T16/T17 twins)
  equals the JAX package's with ``emit_mask`` (jitted, as its domain tick
  runs it), as sets; no contact is emitted by two slabs, and the slabs'
  sets together are the single scene's on the same positions.
* Without JAX: the port's domain against its own single scene over
  ``test_parallel.py``'s 45 ticks and bound 2e-2 (one tick 1e-5).
"""

import pytest

from domain_cases import check_against_jax, check_single, check_slab_sets, run_case
from torch_threads import two_threads  # noqa: F401


@pytest.fixture(scope="module")
def case():
    return run_case("pile")


def test_domain_tick_matches_jax(case):
    check_against_jax(case)


def test_slab_contact_sets_match_jax_and_cover_each_contact_once(case):
    check_slab_sets(case)


def test_domain_matches_the_single_scene():
    check_single("pile")
