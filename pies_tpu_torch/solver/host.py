"""Host-facing ``Solver`` (port of the slice's part of
``pies_tpu/solver/host.py``).

Same keyword surface as the JAX package's ``Solver`` plus ``device=``.  The
ported scope is the PD tick with floor contact and self-contact, on two
paths:

* the tet-column path, for disjoint tet soups (``create_tet_soup``, with
  optional position pins);
* the generic path, for every other scene: every constraint family
  (distance, pins, fused or unfused strain and volume tets, bends, shape
  and goal matching: ``create_box``, ``create_sheet``,
  ``create_bend_sheet``, ``create_shape_matching_box``,
  ``create_shape_matching_sheet``, ``create_tet_box``, an imported mesh
  through ``scene.mesh_dump.add_tet_mesh``, ``add_fixed_regions`` with
  ``update_fixed_regions``, ``add_linked_regions``, ``add_nodes``), and a
  tet soup under full contact coupling or ``tet_cols=False``: the
  assembled operator and PCG (Jacobi, or the exact block preconditioner
  where the disjoint-tet layout covers the capacity), where
  ``cg_iterations``, ``cg_rtol`` and ``rotation_iterations`` take effect
  as in the JAX package, with recentered, diagonal or full contact
  coupling, on the dense floor or its entry list (``dense_floor=False``).

The PBD solver (``SolverOptions(solver=SolverName.PBD)``) runs every scene
the builders make (``create_rope`` among them): pins gated by
``release_hinge``, the distance constraints as rope chains, colour classes
or Jacobi (the host's choice, as in the JAX package), strain and bend, and
with collisions on the node-node response over its pair cache.

Self-contact runs on every PD scene, through the branch the JAX package's
dispatch picks: the packed-body detection on a tet soup, the super-body
detection on a larger triangle scene whose layout it accepts, and
otherwise the per-triangle branches (all-pairs, cell list, per-body cell
list, or the reference sweep under ``broadphase_mode="reference"``).
Edge-edge contacts (``enable_edge_collisions``) and PD node-node contacts
(``enable_node_collisions``) run on the generic path of any PD scene.

Imported closed triangle meshes are tetrahedralized by the lattice mesher
(``add_tri_mesh_volume``).  Every ``Solver`` path of the JAX package runs;
the ensembles and the domain decomposition, on one card or across ranks,
live in ``parallel/``.  ``dense_operator_max`` is accepted and has no effect: the port's generic
path always runs Jacobi-PCG, and the JAX package's dense prefactorization
for small scenes is not ported (ROADMAP, "Not to port").
"""

from __future__ import annotations

import time

import numpy as np
import torch

import dataclasses

from ..collision import broadphase
from ..options import CollisionBudget, SolverName, SolverOptions, StepConfig, make_params
from ..scene.builder import SceneBuilder
from ..state import (
    SolverState,
    empty_broadphase_cache,
    empty_node_pair_cache,
    load_state,
    make_state,
    save_state,
)
from .. import topology as topo_mod
from . import step

_F32 = np.float32

def _detect_chains(idx: np.ndarray, rest: np.ndarray, w: np.ndarray):
    """Split PBD distance constraints into chase chains (``topology.ChainBatch``;
    ``pies_tpu/solver/host.py:53-80``): a chain breaks wherever ``idx1[j] !=
    idx0[j-1]``; the split holds when every written node (``idx0``) is
    unique and no anchor is written.  Returns ``(idx0 [C, L], anchor [C],
    rest [C, L], w [C, L])``, padded with ``w = 0`` links, or None."""
    n = idx.shape[0]
    if n == 0 or np.unique(idx[:, 0]).size != n:
        return None
    brk = np.concatenate([[True], idx[1:, 1] != idx[:-1, 0]])
    starts = np.nonzero(brk)[0]
    ends = np.concatenate([starts[1:], [n]])
    anchors = idx[starts, 1]
    if np.intersect1d(anchors, idx[:, 0]).size:
        return None
    c, lmax = starts.shape[0], int((ends - starts).max())
    idx0 = np.zeros((c, lmax), np.int32)
    rest_t = np.zeros((c, lmax), np.float32)
    w_t = np.zeros((c, lmax), np.float32)
    for ci, (s0, e0) in enumerate(zip(starts, ends)):
        idx0[ci, : e0 - s0] = idx[s0:e0, 0]
        rest_t[ci, : e0 - s0] = rest[s0:e0]
        w_t[ci, : e0 - s0] = w[s0:e0]
    return idx0, anchors.astype(np.int32), rest_t, w_t


def _color_distance(idx: np.ndarray, max_colors: int = 63):
    """Greedy first-fit colouring of PBD distance constraints
    (``pies_tpu/solver/host.py:83-112``): two constraints conflict when they
    share any node.  Returns ``(perm, ends)``, a stable permutation grouping
    the constraints by colour and each class's cumulative end, or None past
    ``max_colors`` colours (Jacobi then)."""
    used: dict[int, int] = {}  # node -> bitmask of the colours touching it
    colors = np.empty(idx.shape[0], np.int32)
    for i in range(idx.shape[0]):
        a, b = int(idx[i, 0]), int(idx[i, 1])
        taken = used.get(a, 0) | used.get(b, 0)
        c = (~taken & (taken + 1)).bit_length() - 1  # lowest zero bit
        if c >= max_colors:
            return None
        colors[i] = c
        used[a] = used.get(a, 0) | (1 << c)
        used[b] = used.get(b, 0) | (1 << c)
    perm = np.argsort(colors, kind="stable")
    return perm, tuple(int(v) for v in np.cumsum(np.bincount(colors)))


def _packed_layout(tris: np.ndarray, stride: int, padded_t: int, cap: int):
    """The packed-body layout (``host.py:649-675``): every body's ``stride``
    triangles span ``m <= 8`` contiguous nodes from ``off + b·m`` with one
    local corner pattern.  Returns ``(m, off, faces)``, ``(0, 0, ())`` when
    the scene does not have it."""
    if stride <= 1 or not tris.shape[0]:
        return 0, 0, ()
    kb = tris.shape[0] // stride
    tn = tris.reshape(kb, stride * 3)
    mins = tn.min(axis=1)
    m = int(tn[0].max() - mins[0] + 1)
    local = tris.reshape(kb, stride, 3) - mins[:, None, None]
    if (
        m <= 8
        and padded_t % stride == 0
        and np.all(tn.max(axis=1) - mins + 1 == m)
        and np.array_equal(mins, mins[0] + np.arange(kb, dtype=mins.dtype) * m)
        and np.all(local == local[0])
        and int(mins[0]) + (padded_t // stride) * m <= cap
    ):
        return m, int(mins[0]), tuple(tuple(int(v) for v in row) for row in local[0])
    return 0, 0, ()


def _detect_super_layout(tris: np.ndarray, bodies: np.ndarray, cap: int):
    """The super-body collision layout of a general triangle scene (the
    port's copy of ``pies_tpu/solver/host.py:114-250``; see
    ``StepConfig.super_*`` and ``broadphase.super_broadphase``).

    * Bodies of more than one triangle must all share one packed structure:
      ``e`` triangles over ``m`` contiguous nodes at ``off + i·m`` with one
      local corner pattern.  Otherwise the layout does not apply.
    * Every single-triangle body is one loose row with explicit corner ids.
    * The static shared-node adjacency (every pair of rows whose node sets
      intersect, the reference's sweep-time skip, ``Solver.cpp:757-770``) is
      enumerated here; a node shared by more than 64 rows, or a row with
      more than 64 neighbours, refuses the layout rather than truncate.

    Returns ``(config_fields, corners i32[K, W], adj i32[K, A] | None)``, or
    None when the layout does not apply."""
    nt = tris.shape[0]
    if nt == 0:
        return None
    first = np.concatenate([[True], bodies[1:] != bodies[:-1]])
    starts = np.nonzero(first)[0]
    ends = np.concatenate([starts[1:], [nt]])
    counts = (ends - starts).astype(np.int64)
    multi = counts > 1
    kp = int(multi.sum())
    m, off = 0, 0
    pat_list: list[tuple[int, int, int]] = []
    if kp:
        e = int(counts[multi][0])
        if not np.all(counts[multi] == e):
            return None
        rows = (starts[multi][:, None] + np.arange(e)[None, :]).reshape(-1)
        tn = tris[rows].reshape(kp, e * 3)
        mins = tn.min(axis=1)
        m = int(tn[0].max() - mins[0] + 1)
        local = tris[rows].reshape(kp, e, 3) - mins[:, None, None]
        if not (
            3 <= m <= 8
            and np.all(tn.max(axis=1) - mins + 1 == m)
            and np.array_equal(mins, mins[0] + np.arange(kp, dtype=mins.dtype) * m)
            and np.all(local == local[0])
        ):
            return None
        off = int(mins[0])
        if off + kp * m > cap:
            return None
        pat_list = [tuple(int(v) for v in r) for r in local[0]]
    e_packed = len(pat_list)
    loose_tris = tris[np.repeat(~multi, counts)]
    tl = loose_tris.shape[0]
    loose_face = -1
    if tl:
        loose_face = pat_list.index((0, 1, 2)) if (0, 1, 2) in pat_list else len(pat_list)
        if loose_face == len(pat_list):
            pat_list.append((0, 1, 2))
    w_c = m if kp else 3
    if w_c * len(pat_list) > 32:
        return None
    live_k = kp + tl
    k = -(-live_k // 8) * 8
    corners = np.zeros((k, w_c), np.int32)
    if kp:
        corners[:kp] = off + (np.arange(kp, dtype=np.int32)[:, None] * m
                              + np.arange(m, dtype=np.int32)[None, :])
    if tl:
        corners[kp: kp + tl, :3] = loose_tris
        if w_c > 3:  # padded by repeating corner 0 (masked out of the combos)
            corners[kp: kp + tl, 3:] = loose_tris[:, :1]

    # (node, row) incidence -> the rows of each node -> all ordered pairs of
    # rows within a node -> each row's neighbour list, ascending.
    # (Pairs are sorted as one int64 key each, which orders them as the JAX
    # package's row-wise ``np.unique`` does, at a fraction of the host time.)
    inc = np.unique(corners[:live_k].reshape(-1).astype(np.int64) * live_k
                    + np.repeat(np.arange(live_k, dtype=np.int64), w_c))
    node_ids, row_ids = inc // live_k, inc % live_k
    uniq, idx_start, g_counts = np.unique(node_ids, return_index=True, return_counts=True)
    adj = None
    gmax = int(g_counts.max()) if g_counts.size else 0
    if gmax > 64:
        return None
    if gmax > 1:
        tab = np.full((uniq.size, gmax), -1, np.int64)
        pos = np.arange(inc.shape[0]) - np.repeat(idx_start, g_counts)
        tab[np.repeat(np.arange(uniq.size), g_counts), pos] = row_ids
        prs = []
        for a in range(gmax):
            va = tab[:, a]
            for bb in range(gmax):
                if a == bb:
                    continue
                vb = tab[:, bb]
                ok = (va >= 0) & (vb >= 0)
                if ok.any():
                    prs.append(va[ok] * live_k + vb[ok])
        if prs:
            allp = np.unique(np.concatenate(prs))
            r1, r2 = allp // live_k, allp % live_k
            _, st, cc = np.unique(r1, return_index=True, return_counts=True)
            a_width = int(cc.max())
            if a_width > 64:
                return None
            adj = np.full((k, a_width), -1, np.int32)
            pos = np.arange(allp.shape[0]) - np.repeat(st, cc)
            adj[r1, pos] = r2.astype(np.int32)

    fields = dict(
        super_k=k, super_packed_k=kp, super_packed_m=m, super_packed_off=off,
        super_live_k=live_k, super_faces=tuple(pat_list), super_packed_e=e_packed,
        super_loose_face=loose_face,
    )
    return fields, corners, adj


class Solver:
    def __init__(
        self,
        options: SolverOptions | None = None,
        *,
        seed: int = 0,
        cg_iterations: int = 16,
        cg_rtol: float = 1e-4,
        rotation_iterations: int = 20,
        enable_collisions: bool = True,
        enable_edge_collisions: bool = False,
        enable_node_collisions: bool = False,
        reference_quirks: bool = True,
        broadphase_mode: str = "celllist",
        contact_coupling: str = "recentered",
        budget=None,
        budget_overrides: dict | None = None,
        node_capacity: int | None = None,
        allpairs_broadphase_max: int | None = None,
        dense_operator_max: int = 2048,
        device: str | torch.device = "cuda",
    ):
        """``device``: where the state lives, "cuda" by default (raises when
        CUDA is absent).  On a CUDA device the tick runs the kernels, on the
        CPU their plain PyTorch twins."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available")
        self._options = options or SolverOptions()
        self._cg_iterations = cg_iterations
        self._cg_rtol = cg_rtol
        self._rotation_iterations = rotation_iterations
        self._builder = SceneBuilder(seed=seed)
        self._enable_collisions = enable_collisions
        self._enable_edge_collisions = enable_edge_collisions
        self._enable_node_collisions = enable_node_collisions
        self._reference_quirks = reference_quirks
        self._broadphase_mode = broadphase_mode
        self._allpairs_max = (StepConfig.allpairs_broadphase_max
                              if allpairs_broadphase_max is None else allpairs_broadphase_max)
        self._contact_coupling = contact_coupling
        self._broadphase_cell = 1.0
        self._broadphase_slack = 0.0
        self._budget = budget
        self._budget_overrides = budget_overrides
        self._node_capacity = node_capacity
        self._device = device

        self._state: SolverState | None = None
        self._topology = None
        self._goal_transforms: np.ndarray | None = None
        self._config: StepConfig | None = None
        self._params = None
        self._params_options = None
        self._prepared_nodes = 0
        self._dirty = True
        self.render_state_dirty = True
        # The PBD hinge toggle (Solver.h:52): True releases the position pins.
        self.release_hinge = False

        self._residual_dev: torch.Tensor | None = None
        self.last_tick_seconds: float = 0.0
        self.ticks: int = 0
        # Device counters summed by every tick while set (pd.new_counters);
        # None, the default, adds no work.
        self.counters: dict[str, torch.Tensor] | None = None

    # ------------------------------------------------------------------
    # scene construction

    def _scene(self, fn, *args, **kwargs):
        out = fn(*args, **kwargs)
        self._dirty = True
        self.render_state_dirty = True
        return out

    def add_nodes(self, vertices):
        return self._scene(self._builder.add_nodes, vertices)

    def create_tet_soup(self, count, spacing, scale, w, **kwargs):
        return self._scene(self._builder.create_tet_soup, count, spacing, scale, w, **kwargs)

    def create_rope(self, start, end, num_nodes, w, **kwargs):
        return self._scene(self._builder.create_rope, start, end, num_nodes, w, **kwargs)

    def create_tet_box(self, translation, scale, initial_velocity, w, mass, hinged=False):
        return self._scene(self._builder.create_tet_box, translation, scale,
                           initial_velocity, w, mass, hinged)

    def create_box(self, translation, scale, w):
        return self._scene(self._builder.create_box, translation, scale, w)

    def create_sheet(self, translation, scale, mass, w):
        return self._scene(self._builder.create_sheet, translation, scale, mass, w)

    def create_shape_matching_box(self, translation, count_x, count_y, count_z, scale,
                                  initial_velocity, w):
        return self._scene(self._builder.create_shape_matching_box, translation, count_x,
                           count_y, count_z, scale, initial_velocity, w)

    def create_shape_matching_sheet(self, translation, scale, initial_velocity, w):
        return self._scene(self._builder.create_shape_matching_sheet, translation, scale,
                           initial_velocity, w)

    def create_bend_sheet(self, translation, scale, w):
        return self._scene(self._builder.create_bend_sheet, translation, scale, w)

    def add_fixed_regions(self, region_matrices, w):
        return self._scene(self._builder.add_fixed_regions, region_matrices, w)

    def add_linked_regions(self, region_matrices, w):
        return self._scene(self._builder.add_linked_regions, region_matrices, w)

    def add_tri_mesh_volume(self, vertices, tri_indices, initial_velocity=(0.0, 0.0, 0.0),
                            density=1.0, strain_stiffness=1000.0, min_strain=0.8,
                            max_strain=1.0, volume_stiffness=1000.0, compression=1.0,
                            stretching=1.0, resolution=8, target_tets=None):
        """Tetrahedralize a closed triangle mesh and add it as a soft body
        (``pies_tpu/solver/host.py:413-456``, the reference's
        ``addTriMeshVolume``, ``PrimitiveUtilities.cpp:164-328``): the
        lattice mesher of ``scene.tetmesh`` in place of tetgen, nodes of
        radius 0.5 and inverse mass ``1/density``, a strain and a volume
        constraint on every tet, and the surface triangles.
        ``target_tets``, when given, overrides ``resolution``."""
        from ..scene.tetmesh import tetrahedralize

        points, tets, surface = tetrahedralize(
            np.asarray(vertices, _F32), np.asarray(tri_indices, np.int32),
            resolution=resolution, target_tets=target_tets)
        b = self._builder
        node_ids = b._emit_nodes(points, velocity=initial_velocity, inv_mass=1.0 / density,
                                 radius=0.5)
        b._emit_tets(node_ids[tets], 0.0, strain=(min_strain, max_strain),
                     volume=(compression, stretching), strain_w=strain_stiffness,
                     volume_w=volume_stiffness)
        b._emit_triangles(node_ids[surface])
        self._dirty = True
        self.render_state_dirty = True
        return node_ids

    def update_fixed_regions(self, region_matrices):
        """Retarget the goal constraints from updated region transforms
        (``PrimitiveUtilities.cpp:114-128``): region r's goal group gets
        ``T = matrix · inverse(initial matrix)``, one small copy to the
        device."""
        regions = self._builder.fixed_regions
        if len(region_matrices) != len(regions):
            raise ValueError(
                f"expected {len(regions)} region matrices, got {len(region_matrices)}")
        self._prepare()
        transforms = self._goal_transforms  # the host's copy: no device read
        for mat, (_, inv_initial, goal_idx) in zip(region_matrices, regions):
            transforms[goal_idx] = np.asarray(mat, _F32).reshape(4, 4) @ inv_initial
        self._topology.goal.transforms.copy_(torch.from_numpy(transforms))

    # ------------------------------------------------------------------
    # stepping

    def _prepare(self):
        if not self._dirty:
            return
        pbd = self._options.solver == SolverName.PBD
        b = self._builder
        num_live = b.num_nodes
        positions = b.all_positions()
        cat = lambda lst, shape: np.concatenate(lst) if lst else np.zeros(shape, _F32)
        tris = cat(b.triangles, (0, 3)).astype(np.int32)
        bodies = (
            np.concatenate(b.tri_bodies).astype(np.int32)
            if b.tri_bodies and sum(x.shape[0] for x in b.tri_bodies) == tris.shape[0]
            else None
        )

        state = make_state(
            positions,
            velocities=cat(b.velocities, (0, 3)),
            inv_mass=b.all_inv_mass(),
            radius=cat(b.radius, (0,)),
            capacity=self._node_capacity,
            device=self._device,
            num_shape_groups=len(b.shape_groups),
        )
        # Live state survives incremental scene additions, like the reference
        # growing its node vector without resetting the sim.
        if self._state is not None and self._prepared_nodes > 0:
            k = min(self._prepared_nodes, num_live)
            for field in ("positions", "prev_positions", "velocities"):
                getattr(state, field)[:k] = getattr(self._state, field)[:k]
            # The rotations of the groups that were there before (groups are
            # append-only in the builder, so old ids are stable) and the
            # failure latch survive too.
            g = min(state.shape_quats.shape[0], self._state.shape_quats.shape[0])
            state.shape_quats[:g] = self._state.shape_quats[:g]
            state.sim_failed.copy_(self._state.sim_failed)
        cap = state.capacity

        inv_mass = b.all_inv_mass()
        dist_idx = cat(b.dist_idx, (0, 2)).astype(np.int32)
        dist_w = cat(b.dist_w, (0,))
        # The PBD distance form (host.py:533-556): rope chains, else colour
        # classes (the batch reordered class by class), else Jacobi.
        distance_colors, chains = (), None
        if pbd and dist_idx.shape[0] > 1:
            dw = np.broadcast_to(np.asarray(dist_w, _F32), (dist_idx.shape[0],))
            rest = np.linalg.norm(positions[dist_idx[:, 1]] - positions[dist_idx[:, 0]],
                                  axis=-1).astype(_F32)
            chains = _detect_chains(dist_idx, rest, dw)
            if chains is None:
                colored = _color_distance(dist_idx)
                if colored is not None and len(colored[1]) > 1:
                    perm, distance_colors = colored
                    dist_idx, dist_w = dist_idx[perm], dw[perm]
        batches = dict(
            distance=topo_mod.build_distance(dist_idx, positions, dist_w),
            bend=topo_mod.build_bend(
                cat(b.bend_idx, (0, 4)).astype(np.int32), positions, cat(b.bend_w, (0,))
            ),
            shape=topo_mod.build_groups(
                [(ids, coords) for ids, coords, _ in b.shape_groups],
                np.asarray([w for _, _, w in b.shape_groups], _F32), inv_mass, kind="shape",
            ),
            goal=topo_mod.build_groups(
                [(ids, coords) for ids, coords, _ in b.goal_groups],
                np.asarray([w for _, _, w in b.goal_groups], _F32), inv_mass, kind="goal",
            ),
            position=topo_mod.build_position(
                cat(b.pos_idx, (0,)).astype(np.int32), positions, cat(b.pos_w, (0,))
            ),
            strain=topo_mod.build_tets(
                cat(b.strain_idx, (0, 4)).astype(np.int32), positions,
                cat(b.strain_w, (0,)), cat(b.strain_lo, (0,)), cat(b.strain_hi, (0,)),
            ),
            volume=topo_mod.build_tets(
                cat(b.volume_idx, (0, 4)).astype(np.int32), positions,
                cat(b.volume_w, (0,)), cat(b.volume_lo, (0,)), cat(b.volume_hi, (0,)),
            ),
        )
        budget = self._budget or self._auto_budget(positions, tris, bodies)
        if self._budget is None and self._budget_overrides:
            budget = dataclasses.replace(budget, **self._budget_overrides)

        def contiguous(idx_list):
            if not idx_list:
                return False
            idx = np.concatenate(idx_list)
            return 4 * (-(-idx.shape[0] // 8) * 8) <= cap and np.array_equal(
                idx.reshape(-1), np.arange(idx.size, dtype=idx.dtype)
            )

        strain_contiguous = contiguous(b.strain_idx)
        volume_contiguous = contiguous(b.volume_idx)
        # Fused strain+volume local step: both sets cover the same tets in the
        # same order (PrimitiveUtilities.cpp:287-316).
        tet_fused = (
            bool(b.strain_idx)
            and len(b.strain_idx) == len(b.volume_idx)
            and all(np.array_equal(s, v) for s, v in zip(b.strain_idx, b.volume_idx))
            and strain_contiguous == volume_contiguous
        )
        topology = topo_mod.assemble_topology(cap, triangles=tris, tet_fused=tet_fused,
                                              **batches)
        if pbd:
            topology = dataclasses.replace(
                topology, jacobi=topo_mod.pbd_incidences(cap, topology),
                chains=None if chains is None else topo_mod.ChainBatch(*chains))
        body_nodes, body_off, body_faces = _packed_layout(
            tris, budget.body_stride, topology.triangles.shape[0], cap)
        # Super-body layout (host.py:681-727): any larger triangle scene
        # without an all-covering uniform body stride.  Its budget holds 64
        # narrow slots and 512 raw candidates per row, because mesh-adjacent
        # rows are dropped only after the raw gather; a user's override wins.
        super_fields = {}
        if (body_nodes == 0 and budget.body_stride == 1 and self._enable_collisions
                and self._broadphase_mode == "celllist" and bodies is not None
                and tris.shape[0] > self._allpairs_max):
            sup = _detect_super_layout(tris, bodies, cap)
            if sup is not None:
                super_fields, corners, adj = sup
                topology = dataclasses.replace(topology, super_corners=corners,
                                               super_adj=adj)
                if self._budget is None:
                    auto = dict(max_narrow_bodies=64, max_candidates_per_body=512)
                    for key in self._budget_overrides or ():
                        auto.pop(key, None)
                    budget = dataclasses.replace(budget, **auto)
        # Cell-list cell size: the largest triangle extent with headroom for
        # deformation and the per-substep sweep (host.py:788-792).
        if tris.shape[0]:
            ext = (positions[tris].max(axis=1) - positions[tris].min(axis=1)).max()
            self._broadphase_cell = float(max(0.25, 1.5 * ext))
        config = StepConfig(
            solver=self._options.solver,
            time_substeps=int(self._options.time_substeps),
            iterations=int(self._options.iterations),
            collision_stabilization_iterations=int(
                self._options.collision_stabilization_iterations),
            cg_iterations=int(self._cg_iterations),
            cg_rtol=float(self._cg_rtol),
            rotation_iterations=int(self._rotation_iterations),
            enable_collisions=bool(self._enable_collisions and (pbd or tris.shape[0])),
            enable_edge_collisions=bool(self._enable_edge_collisions),
            enable_node_collisions=bool(self._enable_node_collisions),
            reference_quirks=self._reference_quirks,
            broadphase_mode=self._broadphase_mode,
            tet_fused=tet_fused,
            allpairs_broadphase_max=self._allpairs_max,
            strain_contiguous=strain_contiguous,
            volume_contiguous=volume_contiguous,
            body_nodes=body_nodes,
            body_node_offset=body_off,
            body_faces=body_faces,
            contact_coupling=self._contact_coupling,
            distance_colors=distance_colors,
            distance_chain=chains is not None,
            budget=budget,
            **super_fields,
        )
        if config.enable_collisions and not pbd:
            broadphase.check_detection(config)
        # The temporal broadphase cache, reset on every prepare (fresh = 0
        # rebuilds at the next detection), with a slack of cell/8: the JAX
        # package's A/B on the 500k soup found it best (host.py:821-844).
        self._broadphase_slack = self._broadphase_cell / 8.0
        if body_nodes > 0 and budget.body_stride > 1:
            kb = int(topology.triangles.shape[0]) // budget.body_stride
            state.bp = empty_broadphase_cache(kb, budget.max_narrow_bodies, kb * body_nodes,
                                              self._device)
        elif super_fields:
            # The super-body cache's reference spans all nodes (host.py:845-858).
            state.bp = empty_broadphase_cache(super_fields["super_k"],
                                              budget.max_narrow_bodies, cap, self._device)
        # The PBD node-pair cache (host.py:859-875), reset on every prepare.
        if pbd and config.enable_collisions:
            state.nn = empty_node_pair_cache(cap, budget.max_candidates_per_node, self._device)
        self._state = state
        self._goal_transforms = np.array(topology.goal.transforms)
        self._topology = topo_mod.to_device(topology, self._device)
        self._config = config
        self._prepared_nodes = num_live
        self._dirty = False

    def _auto_budget(self, positions: np.ndarray, tris: np.ndarray,
                     bodies: np.ndarray | None) -> CollisionBudget:
        """Collision capacities from the scene (``host.py:879-940``).  For
        the cell-list broadphases a uniform triangle count per body (4
        faces of a tet) becomes the body stride (1 for a mixed or a
        single-triangle body scene), and the contact cap follows the
        triangle count.  For the reference sweep the cells per triangle
        follow the largest triangle extent in its grid's cells (world units
        with the quirks, ``grid_spacing`` without), with 2 cells of margin
        per axis."""
        if tris.shape[0] == 0 or positions.shape[0] == 0:
            return CollisionBudget()
        if self._broadphase_mode == "celllist":
            stride = 1
            if bodies is not None and bodies.size:
                _, counts = np.unique(bodies, return_counts=True)
                e = int(counts[0])
                starts = np.nonzero(np.concatenate([[True], bodies[1:] != bodies[:-1]]))[0]
                cap8 = -(-tris.shape[0] // 8) * 8
                if e > 1 and np.all(counts == e) and np.all(starts % e == 0) and cap8 % e == 0:
                    stride = e
            return CollisionBudget(
                max_cells_per_tri=32,
                max_entries_per_cell=32,
                max_candidates_per_tri=96,
                max_point_tri_contacts=max(256, -(-tris.shape[0] // 8) // 8 * 8 + 8),
                max_narrow_candidates=16 if stride > 1 else 32,
                max_narrow_bodies=16 if stride > 1 else 8,
                body_stride=stride,
            )
        scale = 1.0 if self._reference_quirks else self._options.grid_spacing
        p = positions[tris] / scale
        ext = p.max(axis=1) - p.min(axis=1)
        cells = np.prod(np.ceil(ext) + 2.0, axis=1)
        need = int(min(np.max(cells) * 1.5, 512))
        max_cells = int(np.clip(-(-need // 8) * 8, 16, 512))
        return CollisionBudget(
            max_cells_per_tri=max_cells,
            max_candidates_per_tri=max(32, max_cells + 32),
            max_point_tri_contacts=max(256, 2 * tris.shape[0]),
        )

    def current_params(self):
        """The ``PhysicsParams`` a ``tick()`` would use right now, with the
        scene's broadphase cell and cache slack and the hinge toggle; cached
        on those values."""
        self._prepare()
        key = (self._options, bool(self.release_hinge), self._broadphase_cell,
               self._broadphase_slack)
        if self._params is None or self._params_options != key:
            self._params = make_params(self._options, bool(self.release_hinge),
                                       self._broadphase_cell, self._broadphase_slack)
            self._params_options = key
        return self._params

    def tick(self, delta_time: float = 0.0):
        """Advance one tick.  Like the reference, the wall-clock argument is
        ignored in favour of the fixed timestep (``Solver.cpp:40-42,165``).
        Waits for the device, as the JAX package's ``tick`` does, so that
        ``last_tick_seconds`` is the tick's time; ``run_ticks`` waits once
        for all its ticks."""
        params = self.current_params()
        t0 = time.perf_counter()
        self._residual_dev = step.tick(self._state, self._topology, params, self._config,
                                       counters=self.counters)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self.last_tick_seconds = time.perf_counter() - t0
        self.ticks += 1
        self.render_state_dirty = True

    def run_ticks(self, n: int):
        """Advance ``n`` ticks: ``n`` ticks of launches, then one sync."""
        params = self.current_params()
        n = int(n)
        t0 = time.perf_counter()
        res = step.tick_n(self._state, self._topology, params, self._config, n,
                          counters=self.counters)
        if res is not None:
            self._residual_dev = res
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self.last_tick_seconds = (time.perf_counter() - t0) / max(1, n)
        self.ticks += n
        self.render_state_dirty = True

    @property
    def last_residual(self) -> float:
        """Residual of the last tick (read from the device on access)."""
        if self._residual_dev is None:
            return 0.0
        return float(self._residual_dev)

    @last_residual.setter
    def last_residual(self, value: float):
        self._residual_dev = value

    @property
    def sim_failed(self) -> bool:
        if self._state is None:
            return False
        return self._state.failed()

    @property
    def state(self) -> SolverState:
        self._prepare()
        return self._state

    @property
    def topology(self):
        self._prepare()
        return self._topology

    @property
    def options(self) -> SolverOptions:
        return self._options

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def config(self) -> StepConfig:
        self._prepare()
        return self._config

    def save(self, path: str):
        """Checkpoint the state (``host.py:1161-1163``): the JAX package's
        npz of leaves, which either package loads."""
        self._prepare()
        save_state(path, self._state)

    def load(self, path: str):
        """Restore a checkpoint of either package into the prepared scene."""
        self._prepare()
        self._state = load_state(path, self._state)

    def clear(self):
        """Wipe the scene (``Solver::clear``, ``Solver.cpp:488-507``); the
        new builder is seeded with 0, as the JAX package's is."""
        self._builder = SceneBuilder(seed=0)
        self._state = None
        self._topology = None
        self._prepared_nodes = 0
        self._dirty = True
        self.render_state_dirty = True

    # ------------------------------------------------------------------
    # render-facing output (Solver.h:42-49,65-69)

    def get_vertices(self) -> dict[str, np.ndarray]:
        """Positions + radius + PBR material per live node."""
        self._prepare()
        n = self._prepared_nodes
        b = self._builder
        cat = lambda lst, shape: np.concatenate(lst)[:n] if lst else np.zeros(shape, _F32)
        return {
            "position": self._state.positions[:n].cpu().numpy(),
            "radius": self._state.radius[:n].cpu().numpy(),
            "base_color": cat(b.base_color, (0, 3)),
            "roughness": cat(b.roughness, (0,)),
            "metallic": cat(b.metallic, (0,)),
        }

    def get_lines(self) -> np.ndarray:
        """Wireframe index pairs over the distance constraints, flat
        (``Solver.h:67``)."""
        b = self._builder
        return np.concatenate(b.lines).reshape(-1) if b.lines else np.zeros(0, np.int32)

    def get_triangles(self) -> np.ndarray:
        b = self._builder
        return np.concatenate(b.triangles) if b.triangles else np.zeros((0, 3), np.int32)
