"""Host-side scene construction (port of ``pies_tpu/scene/builder.py``).

NumPy only, and the same code as the JAX package's builder for the methods
the slice needs: ``np.random.default_rng(seed)`` is drawn in the same order,
so one seed gives the same jittered scene, bit for bit, in both packages.
The other scene methods of the JAX package are not ported yet.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32
_I32 = np.int32


class SceneBuilder:
    """Accumulates nodes, tet constraints, pins and surface triangles."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.positions: list[np.ndarray] = []
        self.velocities: list[np.ndarray] = []
        self.inv_mass: list[np.ndarray] = []
        self.radius: list[np.ndarray] = []
        # Render attributes (Solver::Vertex, Solver.h:42-49), random per body
        # from the seeded generator.
        self.base_color: list[np.ndarray] = []
        self.roughness: list[np.ndarray] = []
        self.metallic: list[np.ndarray] = []

        self.pos_idx: list[np.ndarray] = []
        self.pos_w: list[np.ndarray] = []
        self.strain_idx: list[np.ndarray] = []
        self.strain_w: list[np.ndarray] = []
        self.strain_lo: list[np.ndarray] = []
        self.strain_hi: list[np.ndarray] = []
        self.volume_idx: list[np.ndarray] = []
        self.volume_w: list[np.ndarray] = []
        self.volume_lo: list[np.ndarray] = []
        self.volume_hi: list[np.ndarray] = []

        self.triangles: list[np.ndarray] = []
        self.tri_bodies: list[np.ndarray] = []
        self.tets: list[np.ndarray] = []

    def _emit_triangles(self, tris: np.ndarray, bodies: np.ndarray | None = None):
        tris = np.asarray(tris, _I32).reshape(-1, 3)
        start = sum(b.shape[0] for b in self.tri_bodies)
        if bodies is None:
            bodies = start + np.arange(tris.shape[0], dtype=_I32)
        self.triangles.append(tris)
        self.tri_bodies.append(np.asarray(bodies, _I32))

    @property
    def num_nodes(self) -> int:
        return sum(p.shape[0] for p in self.positions)

    def all_positions(self) -> np.ndarray:
        if not self.positions:
            return np.zeros((0, 3), _F32)
        return np.concatenate(self.positions, axis=0)

    def all_inv_mass(self) -> np.ndarray:
        if not self.inv_mass:
            return np.zeros((0,), _F32)
        return np.concatenate(self.inv_mass)

    def _emit_nodes(
        self, pos, *, velocity=(0.0, 0.0, 0.0), inv_mass=1.0, radius=0.5
    ) -> np.ndarray:
        """Append a body's nodes; returns their global ids."""
        pos = np.asarray(pos, _F32).reshape(-1, 3)
        n = pos.shape[0]
        start = self.num_nodes
        self.positions.append(pos)
        self.velocities.append(
            np.broadcast_to(np.asarray(velocity, _F32), (n, 3)).copy()
        )
        self.inv_mass.append(np.broadcast_to(np.asarray(inv_mass, _F32), (n,)).copy())
        self.radius.append(np.broadcast_to(np.asarray(radius, _F32), (n,)).copy())
        color = self.rng.random(3).astype(_F32)
        self.base_color.append(np.broadcast_to(color, (n, 3)).copy())
        self.roughness.append(np.full(n, self.rng.random(), _F32))
        self.metallic.append(np.full(n, float(self.rng.integers(0, 2)), _F32))
        return np.arange(start, start + n, dtype=_I32)

    def _emit_tets(self, tets: np.ndarray, w: float, strain=(0.8, 1.0),
                   volume=(1.0, 1.0), strain_w: float | None = None,
                   volume_w: float | None = None):
        tets = np.asarray(tets, _I32).reshape(-1, 4)
        if not tets.size:
            return
        sw = w if strain_w is None else strain_w
        vw = w if volume_w is None else volume_w
        if sw != 0.0:
            self.strain_idx.append(tets)
            self.strain_w.append(np.full(tets.shape[0], sw, _F32))
            self.strain_lo.append(np.full(tets.shape[0], strain[0], _F32))
            self.strain_hi.append(np.full(tets.shape[0], strain[1], _F32))
        if vw != 0.0:
            self.volume_idx.append(tets)
            self.volume_w.append(np.full(tets.shape[0], vw, _F32))
            self.volume_lo.append(np.full(tets.shape[0], volume[0], _F32))
            self.volume_hi.append(np.full(tets.shape[0], volume[1], _F32))
        self.tets.append(tets)

    def create_tet_box(
        self,
        translation,
        scale: float,
        initial_velocity,
        w: float,
        mass: float,
        hinged: bool = False,
    ):
        """Tet lattice box (``PrimitiveUtilities.cpp:330-618``): 3x3x3 grid
        (10x2x10 if hinged), six tets per cell each carrying a strain *and* a
        volume constraint, surface triangles."""
        dims = (10, 2, 10) if hinged else (3, 3, 3)
        _, pos = _lattice(dims, scale, translation)
        node_ids = self._emit_nodes(
            pos,
            velocity=initial_velocity,
            inv_mass=1.0 / mass,
            radius=0.95 * 0.5 * scale,
        )
        gid = node_ids.reshape(dims)
        self._emit_tets(_six_tets_per_cell(gid), w)
        self._emit_triangles(_box_surface_tris(gid))

    def create_tet_soup(
        self, count: int, spacing: float, scale: float, w: float, mass=1.0,
        jitter: float = 0.0, height: float = 2.0,
    ):
        """Many independent single-tet bodies on a 3D grid — the stress-bench
        scene (BASELINE.json config 5)."""
        side = int(np.ceil(count ** (1.0 / 3.0)))
        g = np.stack(
            np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), axis=-1
        ).reshape(-1, 3)[:count].astype(_F32)
        origins = g * spacing + np.asarray([0.0, height, 0.0], _F32)
        if jitter:
            origins += self.rng.standard_normal(origins.shape).astype(_F32) * jitter
        unit = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], _F32) * scale
        pos = (origins[:, None, :] + unit[None, :, :]).reshape(-1, 3)
        node_ids = self._emit_nodes(pos, inv_mass=1.0 / mass, radius=0.4 * scale)
        tets = node_ids.reshape(-1, 4)
        self._emit_tets(tets, w)
        # All four faces of each tet, outward winding; each tet is one
        # collision body.
        faces = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], _I32)
        start_body = sum(b.shape[0] for b in self.tri_bodies)
        bodies = start_body + np.repeat(np.arange(tets.shape[0], dtype=_I32), 4)
        self._emit_triangles(tets[:, faces].reshape(-1, 3), bodies)
        return node_ids


# ---------------------------------------------------------------------------
# lattice helpers (pies_tpu/scene/builder.py:444-548)


def _lattice(dims, scale, translation):
    """Positions for an x-major lattice, matching the reference's loop order
    (``PrimitiveUtilities.cpp:355-373``)."""
    i, j, k = np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")
    pos = (
        scale * np.stack([i, j, k], axis=-1).reshape(-1, 3).astype(_F32)
        + np.asarray(translation, _F32)
    )
    return np.arange(pos.shape[0], dtype=_I32), pos


def _six_tets_per_cell(gid):
    """The reference's 6-tet cell decomposition
    (``PrimitiveUtilities.cpp:401-514``)."""
    c000 = gid[:-1, :-1, :-1].reshape(-1)
    c001 = gid[:-1, :-1, 1:].reshape(-1)
    c010 = gid[:-1, 1:, :-1].reshape(-1)
    c011 = gid[:-1, 1:, 1:].reshape(-1)
    c100 = gid[1:, :-1, :-1].reshape(-1)
    c101 = gid[1:, :-1, 1:].reshape(-1)
    c110 = gid[1:, 1:, :-1].reshape(-1)
    c111 = gid[1:, 1:, 1:].reshape(-1)
    tets = [
        (c000, c001, c011, c111),
        (c000, c010, c011, c111),
        (c000, c001, c101, c111),
        (c000, c100, c101, c111),
        (c000, c010, c110, c111),
        (c000, c100, c110, c111),
    ]
    return np.concatenate([np.stack(t, axis=-1) for t in tets], axis=0).astype(_I32)


def _box_surface_tris(gid):
    """Surface triangulation of a lattice box, all six faces wound outward
    (``PrimitiveUtilities.cpp:519-606``)."""
    tris = []

    def face(grid2d, flip):
        a = grid2d[:-1, :-1].reshape(-1)
        b = grid2d[1:, 1:].reshape(-1)
        c = grid2d[1:, :-1].reshape(-1)
        d = grid2d[:-1, 1:].reshape(-1)
        if flip:
            tris.append(np.stack([a, b, c], axis=-1))
            tris.append(np.stack([a, d, b], axis=-1))
        else:
            tris.append(np.stack([a, c, b], axis=-1))
            tris.append(np.stack([a, b, d], axis=-1))

    face(gid[:, :, 0], True)
    face(gid[:, :, -1], False)
    face(gid[:, 0, :], False)
    face(gid[:, -1, :], True)
    face(gid[0, :, :], True)
    face(gid[-1, :, :], False)
    return np.concatenate(tris, axis=0).astype(_I32)
