"""The port's assembled ELL operator and its Jacobi-PCG against a dense
float64 solve, on the CPU.

On the 1,331-node imported mesh with four pins, the dense oracle is built
here in float64 from the constraint definitions themselves (the mass
diagonal ``M/h²``, each pin's weight, each strain and volume tet's
``w·GᵀG``), independently of the host's ELL assembly.  The port's operator
(``assembly.apply_system_plain`` over ``Topology.ell_nbr``/``ell_coef``) and
its Jacobi-PCG (``assembly.pcg_solve_plain``) run in float64 on the same
topology; the only difference left is the ELL coefficients' rounding to
float32 on the host.
"""

import dataclasses
import os

import numpy as np
import torch

import pies_tpu_torch as pt
from pies_tpu_torch.scene.mesh_dump import add_tet_mesh, load_mesh_txt
from pies_tpu_torch.solver import assembly

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

MESH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "scripts", "refbench", "tet_cube_mesh.txt")
PINS = (0, 10, 110, 120)


def _f64(obj):
    """A copy of a topology dataclass with every float32 tensor in float64."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _f64(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, torch.Tensor) and obj.dtype == torch.float32:
        return obj.double()
    return obj


def _dense_operator(st, topo, h2: float) -> np.ndarray:
    """``M/h² + Σ_pins w + Σ_tets w·GᵀG`` as a dense float64 matrix."""
    n = st.capacity
    a = np.diag(st.mass.double().numpy() / h2)
    p = topo.position
    np.add.at(a, (p.idx.numpy(), p.idx.numpy()), p.w.double().numpy())
    for t in (topo.strain, topo.volume):
        live = t.w.numpy() > 0
        idx = t.idx.numpy()[live]
        g = t.g.double().numpy().T.reshape(-1, 3, 4)[live]
        gtg = np.einsum("cja,cjb->cab", g, g) * t.w.double().numpy()[live][:, None, None]
        for i in range(4):
            for j in range(4):
                np.add.at(a, (idx[:, i], idx[:, j]), gtg[:, i, j])
    assert a.shape == (n, n)
    return a


def test_ell_operator_and_pcg_match_a_dense_solve():
    """The ELL operator equals the dense oracle on random vectors within
    1e-6 of the largest product (float32 coefficients); 400 Jacobi-PCG trips
    from zero land within 1.7e-5 of ``torch.linalg.solve`` relative to the
    solution's largest entry, the bound the JAX package's ELL operator was
    held to against its dense inverse (measured here: 6.5e-7, converged from
    100 trips on; the operator 5.0e-8)."""
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu")
    add_tet_mesh(s, *load_mesh_txt(MESH), pins=PINS)
    st, topo = s.state, s.topology
    assert topo.ell_nbr is not None and topo.csr_start is None
    h = np.float32(s.current_params().dt)
    h2 = float(h * h)
    n = st.capacity
    a = torch.from_numpy(_dense_operator(st, topo, h2))
    t64 = _f64(topo)
    mass, wf = st.mass.double(), torch.zeros(n, dtype=torch.float64)
    live = st.node_mask.double()[:, None]

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(n, 3))) * live
    y, _ = assembly.apply_system_plain(x, mass, wf, h2, t64)
    ref = a @ x
    assert float((y - ref).abs().max()) <= 1e-6 * float(ref.abs().max())

    b = torch.from_numpy(rng.normal(size=(n, 3))) * 1e3 * live
    diag = torch.diagonal(a).clone()
    sol, _, trips = assembly.pcg_solve_plain(b, torch.zeros_like(b), diag, mass, wf, h2,
                                             st.node_mask.double(), t64, 400)
    exact = torch.linalg.solve(a, b)
    err = float((sol - exact).abs().max()) / float(exact.abs().max())
    assert int(trips[0]) == 400
    assert err <= 1.7e-5, err
