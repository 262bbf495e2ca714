"""The port's package root and options against the JAX package's.

* ``make_params`` takes the JAX package's argument order, ``(options,
  release_hinge=False, broadphase_cell=1.0, broadphase_slack=0.0)``, so a
  positional call means the same in both: ``make_params(o, True)`` releases
  the hinge, and a fully positional call sets the cell and the slack.
* ``split_options`` maps the options onto the same config fields and
  parameters as the JAX package's, overrides included.
* The port's ``__all__`` holds every name of ``pies_tpu.__all__``.
"""

import dataclasses

import numpy as np
import pytest

import pies_tpu
from pies_tpu.options import SolverOptions as JOptions, make_params as jmake_params
from pies_tpu.options import split_options as jsplit_options
import pies_tpu_torch as pt
from pies_tpu_torch import convert

OPTIONS = dict(fixed_timestep_size=0.01, time_substeps=2, iterations=6,
               collision_stabilization_iterations=3, friction=0.3)


def _params(p):
    return {f.name: float(np.asarray(getattr(p, f.name))) for f in dataclasses.fields(p)}


@pytest.mark.parametrize("args", [(True,), (False, 1.5), (True, 1.5, 0.25)],
                         ids=["hinge", "cell", "positional"])
def test_make_params_positional_calls_match_reference(args):
    ours = _params(pt.make_params(pt.SolverOptions(**OPTIONS), *args))
    ref = _params(jmake_params(JOptions(**OPTIONS), *args))
    assert ours == ref
    assert ours["release_hinge"] == float(args[0])


def test_split_options_matches_reference():
    cfg, params = pt.split_options(pt.SolverOptions(**OPTIONS), tet_cols=False,
                                   enable_collisions=False)
    jcfg, jparams = jsplit_options(JOptions(**OPTIONS), tet_cols=False,
                                   enable_collisions=False)
    assert cfg == convert.config_from(jcfg)
    assert (cfg.time_substeps, cfg.iterations, cfg.collision_stabilization_iterations) == (2, 6, 3)
    assert cfg.dtype == jcfg.dtype == "float32"
    assert _params(params) == _params(jparams)


def test_package_root_exports_the_reference_names():
    assert set(pies_tpu.__all__) <= set(pt.__all__)
    for name in pt.__all__:
        assert getattr(pt, name) is not None
