"""Host-side scene construction (port of ``pies_tpu/scene/builder.py``).

NumPy only, and the same code as the JAX package's builder for the methods
that are ported: ``np.random.default_rng(seed)`` is drawn in the same order,
so one seed gives the same scene, bit for bit, in both packages.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32
_I32 = np.int32


class SceneBuilder:
    """Accumulates nodes, constraints and render topology; mirrors the
    mutation surface of ``Pies::Solver``'s scene methods (``Solver.h:75-116``)."""

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

        self.dist_idx: list[np.ndarray] = []
        self.dist_w: list[np.ndarray] = []
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
        self.bend_idx: list[np.ndarray] = []
        self.bend_w: list[np.ndarray] = []
        # [(node_ids, material_coords, w)]
        self.shape_groups: list[tuple[np.ndarray, np.ndarray, float]] = []
        self.goal_groups: list[tuple[np.ndarray, np.ndarray, float]] = []
        # Fixed regions: (initial_transform, inv_initial_transform,
        # goal_group_index) — Solver.h:148-152.
        self.fixed_regions: list[tuple[np.ndarray, np.ndarray, int]] = []

        self.triangles: list[np.ndarray] = []
        self.tri_bodies: list[np.ndarray] = []
        self.tets: list[np.ndarray] = []
        self.lines: list[np.ndarray] = []

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

    def _emit_distance(self, pairs: np.ndarray, w: float):
        pairs = np.asarray(pairs, _I32).reshape(-1, 2)
        if pairs.size:
            self.dist_idx.append(pairs)
            self.dist_w.append(np.full(pairs.shape[0], w, _F32))
            self.lines.append(pairs.copy())

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

    def add_nodes(self, vertices) -> np.ndarray:
        """Free particles: mass 1, radius 0.5
        (``PrimitiveUtilities.cpp:42-75``)."""
        return self._emit_nodes(vertices, inv_mass=1.0, radius=0.5)

    def create_box(self, translation, scale: float, w: float):
        """5x5x5 distance-constraint lattice (``PrimitiveUtilities.cpp:620-847``):
        axis-aligned edges plus the four long diagonals of every cell, surface
        triangles, wireframe lines."""
        dims = (5, 5, 5)
        _, pos = _lattice(dims, scale, translation)
        node_ids = self._emit_nodes(pos, inv_mass=1.0, radius=0.5 * scale)
        gid = node_ids.reshape(dims)

        pairs = _axis_pairs(gid) + _long_diagonal_pairs(gid)
        self._emit_distance(np.concatenate(pairs, axis=0), w)
        self._emit_triangles(_box_surface_tris(gid))

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

    def create_sheet(self, translation, scale: float, mass: float, w: float):
        """20x20 cloth (``PrimitiveUtilities.cpp:849-976``): border nodes
        pinned, distance constraints along both axes and both diagonals."""
        width = height = 20
        i, j = np.meshgrid(np.arange(width), np.arange(height), indexing="ij")
        pos = np.stack(
            [scale * i, np.zeros_like(i, _F32), scale * j], axis=-1
        ).reshape(-1, 3).astype(_F32) + np.asarray(translation, _F32)
        node_ids = self._emit_nodes(pos, inv_mass=1.0 / mass, radius=0.5 * scale)
        gid = node_ids.reshape(width, height)

        border = (
            (i == 0) | (i == width - 1) | (j == 0) | (j == height - 1)
        ).reshape(-1)
        self.pos_idx.append(node_ids[border])
        self.pos_w.append(np.full(border.sum(), w, _F32))

        self._emit_distance(np.concatenate(sheet_distance_pairs(gid), axis=0), w)
        self._emit_triangles(_sheet_tris(gid))

    def create_shape_matching_box(
        self, translation, count_x, count_y, count_z, scale, initial_velocity, w
    ):
        """Shape-matching lattice (``PrimitiveUtilities.cpp:985-1048``):
        scale forced to 0.5, invMass 1/10, one group over all nodes."""
        scale = 0.5  # the reference overrides the parameter
        dims = (count_x, count_y, count_z)
        _, pos = _lattice(dims, scale, translation)
        node_ids = self._emit_nodes(
            pos, velocity=initial_velocity, inv_mass=0.1, radius=0.5 * scale
        )
        self.shape_groups.append((node_ids, pos.copy(), float(w)))

    def create_shape_matching_sheet(self, translation, scale, initial_velocity, w):
        """50x50 sheet of overlapping 3x3 shape-matching patches sharing
        boundary nodes (``PrimitiveUtilities.cpp:1050-1125``)."""
        width = height = 50
        pw = ph = 3
        i, j = np.meshgrid(np.arange(width), np.arange(height), indexing="ij")
        pos = np.stack(
            [scale * i, scale * j, np.zeros_like(i, _F32)], axis=-1
        ).reshape(-1, 3).astype(_F32) + np.asarray(translation, _F32)
        node_ids = self._emit_nodes(
            pos, velocity=initial_velocity, inv_mass=1.0, radius=0.5 * scale
        )

        patches: dict[int, list[int]] = {}
        flat_i, flat_j = i.reshape(-1), j.reshape(-1)
        for k in range(width * height):
            ii, jj = int(flat_i[k]), int(flat_j[k])
            pids = [(ii // pw) * ph + (jj // ph)]
            if ii % pw == pw - 1 and ii < width - 1:
                pids.append((1 + ii // pw) * ph + jj // ph)
            if jj % ph == ph - 1 and jj < height - 1:
                pids.append((ii // pw) * ph + jj // ph + 1)
            for pid in pids:
                patches.setdefault(pid, []).append(k)

        for pid in sorted(patches):
            members = np.asarray(patches[pid], _I32)
            self.shape_groups.append((node_ids[members], pos[members].copy(), float(w)))

    def create_bend_sheet(self, translation, scale, w):
        """10x10 bending cloth (``PrimitiveUtilities.cpp:1127-1289``): first
        three columns pinned, distance constraints (axes + one diagonal),
        bend constraints across the cell diagonal and adjacent cells."""
        width = height = 10
        i, j = np.meshgrid(np.arange(width), np.arange(height), indexing="ij")
        pos = np.stack(
            [scale * i, np.zeros_like(i, _F32), scale * j], axis=-1
        ).reshape(-1, 3).astype(_F32) + np.asarray(translation, _F32)
        node_ids = self._emit_nodes(pos, inv_mass=1.0, radius=0.5 * scale)
        gid = node_ids.reshape(width, height)

        pinned = (i < 3).reshape(-1)
        self.pos_idx.append(node_ids[pinned])
        self.pos_w.append(np.full(pinned.sum(), w, _F32))

        self._emit_distance(np.concatenate(sheet_distance_pairs(gid)[:3], axis=0), w)
        bend_all = sheet_bends(gid)
        self.bend_idx.append(bend_all)
        self.bend_w.append(np.full(bend_all.shape[0], w, _F32))
        self._emit_triangles(_sheet_tris(gid))

    # ------------------------------------------------------------------
    # region APIs (the Maya-rig driving path)

    def add_fixed_regions(self, region_matrices, w: float):
        """OBB region selection → one ``GoalMatchingConstraint`` per region,
        empty ones included (``PrimitiveUtilities.cpp:77-112``)."""
        pos = self.all_positions()
        for mat in region_matrices:
            mat = np.asarray(mat, _F32).reshape(4, 4)
            inv = np.linalg.inv(mat)
            sel = _nodes_in_unit_box(pos, inv)
            self.fixed_regions.append((mat, inv, len(self.goal_groups)))
            self.goal_groups.append((sel.astype(_I32), pos[sel].copy(), float(w)))

    def add_linked_regions(self, region_matrices, w: float):
        """OBB region selection → one ``ShapeMatchingConstraint`` per region
        with ≥3 nodes (``PrimitiveUtilities.cpp:130-162``)."""
        pos = self.all_positions()
        for mat in region_matrices:
            inv = np.linalg.inv(np.asarray(mat, _F32).reshape(4, 4))
            sel = _nodes_in_unit_box(pos, inv)
            if sel.shape[0] >= 3:
                self.shape_groups.append((sel.astype(_I32), pos[sel].copy(), float(w)))

    def create_rope(
        self, start, end, num_nodes: int, w: float, mass=1.0, radius=None,
        pin_start: bool = True, pin_end: bool = False,
    ):
        """Rope of ``num_nodes`` particles chained by distance constraints
        (``pies_tpu/scene/builder.py:366-400``).  ``radius`` defaults to 40%
        of the segment spacing, at most 0.25, so chain neighbours never start
        overlapping.  The links are ordered outer node first (only a pair's
        node 0 moves under the PBD projection, ``Constraints.cpp:34``), so
        each node chases toward the pinned start."""
        t = np.linspace(0.0, 1.0, num_nodes, dtype=_F32)[:, None]
        pos = np.asarray(start, _F32) * (1 - t) + np.asarray(end, _F32) * t
        if radius is None:
            spacing = float(
                np.linalg.norm(np.asarray(end, _F32) - np.asarray(start, _F32))
            ) / max(num_nodes - 1, 1)
            radius = min(0.25, 0.4 * spacing)
        node_ids = self._emit_nodes(pos, inv_mass=1.0 / mass, radius=radius)
        self._emit_distance(np.stack([node_ids[1:], node_ids[:-1]], axis=-1), w)
        pins = []
        if pin_start:
            pins.append(node_ids[0])
        if pin_end:
            pins.append(node_ids[-1])
        if pins:
            self.pos_idx.append(np.asarray(pins, _I32))
            self.pos_w.append(np.full(len(pins), w, _F32))
        return node_ids

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
# lattice helpers (pies_tpu/scene/builder.py:444-559)


def _lattice(dims, scale, translation):
    """Positions for an x-major lattice, matching the reference's loop order
    (``PrimitiveUtilities.cpp:355-373``)."""
    i, j, k = np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")
    pos = (
        scale * np.stack([i, j, k], axis=-1).reshape(-1, 3).astype(_F32)
        + np.asarray(translation, _F32)
    )
    return np.arange(pos.shape[0], dtype=_I32), pos


def _stack_pairs(a, b):
    return np.stack([a.reshape(-1), b.reshape(-1)], axis=-1).astype(_I32)


def _axis_pairs(gid):
    return [
        _stack_pairs(gid[:-1, :, :], gid[1:, :, :]),
        _stack_pairs(gid[:, :-1, :], gid[:, 1:, :]),
        _stack_pairs(gid[:, :, :-1], gid[:, :, 1:]),
    ]


def _long_diagonal_pairs(gid):
    """The four body diagonals of every lattice cell
    (``PrimitiveUtilities.cpp:702-724``)."""
    c000 = gid[:-1, :-1, :-1]
    c001 = gid[:-1, :-1, 1:]
    c010 = gid[:-1, 1:, :-1]
    c011 = gid[:-1, 1:, 1:]
    c100 = gid[1:, :-1, :-1]
    c101 = gid[1:, :-1, 1:]
    c110 = gid[1:, 1:, :-1]
    c111 = gid[1:, 1:, 1:]
    return [
        _stack_pairs(c000, c111),
        _stack_pairs(c100, c011),
        _stack_pairs(c010, c101),
        _stack_pairs(c001, c110),
    ]


def sheet_distance_pairs(gid):
    """The distance families of a sheet lattice ``gid`` i32[W, H]
    (``create_sheet``, ``builder.py:212-217``): both axes, then the two cell
    diagonals; ``create_bend_sheet`` takes the first three."""
    return [
        _stack_pairs(gid[:-1, :], gid[1:, :]),
        _stack_pairs(gid[:, :-1], gid[:, 1:]),
        _stack_pairs(gid[:-1, :-1], gid[1:, 1:]),
        _stack_pairs(gid[1:, :-1], gid[:-1, 1:]),
    ]


def sheet_bends(gid):
    """The bend families of a sheet lattice ``gid`` i32[W, H]
    (``create_bend_sheet``, ``builder.py:294-330``) as i32[C, 4]: across
    every cell's diagonal (00, 11 | 10, 01)
    (``PrimitiveUtilities.cpp:1214-1222``), then across the edges that
    adjacent cells share (``PrimitiveUtilities.cpp:1224-1249``)."""
    flat = lambda *views: np.stack([v.reshape(-1) for v in views], axis=-1)  # noqa: E731
    return np.concatenate([
        flat(gid[:-1, :-1], gid[1:, 1:], gid[1:, :-1], gid[:-1, 1:]),
        flat(gid[1:-1, :-2], gid[1:-1, 1:-1], gid[:-2, :-2], gid[2:, 1:-1]),
        flat(gid[:-2, 1:-1], gid[1:-1, 1:-1], gid[:-2, :-2], gid[1:-1, 2:]),
    ], axis=0)


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


def _sheet_tris(gid):
    """Two triangles per sheet cell (``PrimitiveUtilities.cpp:933-944``)."""
    a = gid[:-1, :-1].reshape(-1)
    b = gid[1:, 1:].reshape(-1)
    c = gid[1:, :-1].reshape(-1)
    d = gid[:-1, 1:].reshape(-1)
    return np.concatenate(
        [np.stack([a, b, c], axis=-1), np.stack([a, d, b], axis=-1)], axis=0
    ).astype(_I32)


def _nodes_in_unit_box(pos: np.ndarray, inv_transform: np.ndarray) -> np.ndarray:
    """Node ids whose region-local coordinates lie in [-1, 1]³
    (``PrimitiveUtilities.cpp:100-107``)."""
    if pos.shape[0] == 0:
        return np.zeros(0, np.int64)
    h = np.concatenate([pos, np.ones((pos.shape[0], 1), _F32)], axis=1)
    local = h @ inv_transform.T
    inside = np.all(np.abs(local[:, :3]) <= 1.0, axis=1)
    return np.nonzero(inside)[0]
