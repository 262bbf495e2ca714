#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``pies_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):

0. The card: ``nvidia-smi`` name and power limit, torch / CUDA / nvcc
   versions, whether ``triton`` imports.  No CUDA device: exit 2.
1. Build the 30 kernels from ``pies_tpu_torch/kernels/csrc`` with nvcc,
   one process per source, all at once (``-Xptxas -v`` output printed), and
   report the build time.
2. T1-T4 against their plain PyTorch twins on the card, at the main path's
   shapes (125,000 tets, 500,000 nodes) from the seeded scene: T1 forces
   within 1e-4 of the largest, T2 positions within 1e-4, T3 and T4 within
   1 ulp.  Times from CUDA events, kernel beside twin.
2b. T5-T8 against their twins at 500k on a contact-active state (the bench
   scene with self-contact after 45 ticks of the kernels): T5's cache and
   flags equal (as found, and with a rebuild forced), T6's contacts equal
   (as found, and with the positions jittered so that points cross face
   planes and the cubic runs), T7's incidence and diagonal equal and its
   force, T2's one-iteration contact mode given T7's force, T2's contact
   substep (4 iterations in one cooperative launch, the first iteration's
   tet force computed inside as on the main path, the contact tets first,
   T7's force inside: bit-equal to its twin, timed as its own row of the
   kernels line) and T8
   (one cooperative launch: bit-equal).  Then each T5-T8 call's device
   work kernel by kernel (the profiler's CUDA events): T5 one kernel a call
   as found and one with a rebuild forced (beside the fill that forces
   it), T6, T7's setup, T2's contact substep and T8 one kernel a call, all
   with no memcpy and no memset, T7's force one kernel.
3. The contact-free main path: ``Solver(SolverOptions(solver=PD),
   enable_collisions=False)`` on ``create_tet_soup(125_000, spacing=1.6,
   scale=0.8, w=2000.0, height=0.5, jitter=0.05)``; 30 warm-up ticks (the
   soup reaches the floor at tick ~25), then a timed ``run_ticks(10)`` with
   the launch counters reset to 0 before it.  Checks: no sim_failed, finite
   positions, floor-active nodes in the window (a device counter), every
   counter of T2-T4 > 0 (T2 computes the first iteration's tet force, so
   T1's wrapper launches nothing on the path).  The same run with the
   plain twins on the card is timed too, and its final positions are held
   against the kernels' run.
3b. The main path with self-contact: the same scene with
   ``enable_collisions=True``; 45 warm-up ticks (its layers meet only after
   the bottom one stops on the floor, at tick ~40), then 10 timed ticks
   enqueued by ``step.tick_n`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (no call may make the host
   wait for the device; the closing synchronize outside).  Checks as in
   phase 3, plus live contacts in the window, every counter of T2-T8 > 0
   and T1's at 0, and every T2 call a contact substep with T7's force
   inside (no standalone force, one call a substep); prints contacts per
   tick and cache rebuilds, then a traced copy of the window from tick 45:
   wrapper calls, kernels, memcpys, memsets and device busy per tick,
   checking T5, T2's contact substep and T8 at 1 kernel a substep each, no
   memcpy and no memset.  The plain
   twins' run is held to 1e-3.
4. Kernels against twins on the card over 40 ticks of a 4,096-tet soup:
   max |dx| <= 1e-3; then with self-contact at spacing 1.0, where the
   contact counts must also be equal on every tick.
5. The generic path at full size: the imported 110,592-node / 622,938-tet
   mesh (``scripts/refbench/tet_cube_mesh_100k.txt``, a cube of side 12
   with its bottom at y = 3) through ``Solver(SolverOptions(solver=PD),
   enable_collisions=False)`` and ``scene.mesh_dump.add_tet_mesh`` (the
   scene of ``scripts/bench_all.py:116-121``); 75 warm-up ticks, the bottom
   reaching the floor at tick 70 (the floor-active device counter, read
   per tick from tick 60, says when).
2c. (on that warmed state) T9-T11 against their twins, one substep's
   shapes: T9's tet forces, force and static projection, T10's product and
   partials, and T11's solve (16 trips, rtol 1e-4 as the path runs it):
   solution, residual partials and trip count.  Then phase 5 proper: a
   timed ``run_ticks(10)`` over ticks 76-85 with the launch counters reset
   to 0 before it; checks: no sim_failed, finite positions, floor contact
   in the window, every counter of T3, T9, T10, T11 and T4 > 0; prints
   ms/tick, steps/s, CG trips and launches per tick.  From the warmed
   state, 3 ticks of the kernels against 3 of the twins (positions within
   1e-3, equal counters); then 40 ticks of the 1,331-node mesh
   (``tet_cube_mesh.txt``, 4 pinned nodes, floor contact from tick ~27),
   kernels against twins: positions within 1e-3 and the counters equal.

6. The rigged cloth at full size (``scene.rigged_cloth.add_rigged_cloth``:
   a 512 x 512 lattice, 262,144 nodes, 1,045,506 distance pairs, 781,321
   bends, 522,242 triangles, one fixed region of 1,536 nodes and 1,024
   linked regions of 64; scale 0.1, height 0.3, w = 5000) through
   ``Solver(SolverOptions(solver=PD), enable_collisions=False)``: the
   generic path with every constraint family but the tets.  Warm-up tick by
   tick until the first floor-active one (tick ~19).
2d. (on that warmed state) T12's distance and bend rows, T13's shape and
   goal rows and rotations, T9's stage 2 over all families' rows and T10
   (ELL width 9, with the static weight) against their twins: equal where
   no ``acos``/``sin``/``cos`` is involved, else within 1e-6 of the largest
   row; T10 also against ``torch.sparse.mm``.  Then phase 6 proper: the
   fixed region turned by 0.05 rad (``update_fixed_regions``) and a timed
   ``run_ticks(10)``, launch counters reset before; checks: no sim_failed,
   finite positions, floor contact in the window, every counter of T3, T12,
   T13, T9's stage 2, T10, T11 and T4 > 0, the goal transform not the
   identity.  From the warmed state, 3 ticks of the kernels against 3 of
   the twins (positions within 1e-3, equal counters).
6b. Shape-matching blobs (``scripts/bench_all.py:155-166`` at 4,096
   bodies): ``create_shape_matching_box(.., 5, 5, 5, 1.0, v, 4000.0)`` with
   a seeded velocity per body and a seeded spin added to the state (so
   that the rotation extraction has work), 512,000 nodes, 4,096 groups of
   125, free flight (these bodies have no triangles, so the floor never
   acts on them); 5 warm-up ticks, T13 against its twin at this shape, a
   timed ``run_ticks(10)`` with the CG trips reported, and 3 ticks of
   kernels against twins.

7. The cloth over the soup at full size (``scene.mixed_drape.add_mixed_drape``:
   125,000 tets and a 100 x 100 sheet, 510,000 nodes, 519,602 triangles,
   144,602 collision rows) through ``Solver(SolverOptions(solver=PD))`` with
   its default arguments (self-contact on, recentered coupling): the
   generic path with the super-body detection, the contact terms and the
   banded tet operator.  35 warm-up ticks, then tick by tick until a sheet
   node and a soup triangle (or the reverse) are in contact.
2e. (on that warmed state) T14 against its twin (cache, flags and latch
   equal, as found and with a rebuild forced), T15 against its twin
   (contacts equal, as found and with the positions jittered so that the
   cubic runs), T7's setup with the operator's dense diagonal, T9's stage 2
   with the contact terms, T10's band form (also against
   ``torch.sparse.mm``) and the PCG with the contact diagonal: equal to
   their twins.  Then phase 7 proper: a timed ``run_ticks(10)``, launch
   counters reset before; checks: no sim_failed, finite positions, floor
   contact and contacts in the window, sheet-soup contacts after it (one
   detection, counted on the host), every counter of T3, T14, T15, T7, T9,
   T12, T10, T11, T8 and T4 > 0.  From the warmed state, 3 ticks of the
   kernels against 3 of the twins (positions within 1e-3, equal counters).
5b, 6c. The mesh of phase 5 and the cloth of phase 6 with
   ``enable_collisions=True`` (pure-loose layouts: one row per triangle,
   W = 3, one face slot), the same ticks as those phases ran, launch
   counters reset before: no sim_failed, contacts printed, every kernel of
   the path launched; without a contact the positions equal the
   collisions-off run's bit for bit (a zero contact diagonal and force add
   exactly nothing).  Then T14 and T15 against their twins at these shapes,
   on the state as found and on that state folded over itself (a strip
   mirrored back onto the part beside it, its nodes seeded distances above
   and under where they land): cache, latches and contact lists equal, with
   contacts and crossing combos present.
8. A small mixed scene (4,096 tets, a 32 x 32 sheet at y = 2.2, in contact
   from the first tick), 40 ticks, kernels against twins: contact counts
   equal on every tick, positions within 1e-3.

9. The reference's scenes with the default arguments and self-contact on
   (9a: ``create_sheet``, two tet boxes, five stacked boxes, the boxes
   under ``broadphase_mode="reference"``, and ``create_sheet`` under
   ``contact_coupling="full"``; 40 ticks each, kernels against twins, then
   a timed ``run_ticks(10)``); 9b holds T16 and T17 against their twins
   inside phases 2b and 5b.
10. The PBD solver (T18-T21), ``Solver(SolverOptions(solver=PBD))`` with
   the default 4 iterations.  First the small scenes, 40 ticks each, kernels
   against twins (counters equal on every tick, no latch, positions within
   1e-3): the colour classes on the 8 x 8 net of ``tests/test_solver.py`` and
   a ``create_box``, strain on a ``create_tet_box`` in both quirk modes, bends
   on a ``create_bend_sheet``.  Then the cells, all with collisions on:
   ``rope_pbd`` (2,048 particles) and ``pbd_node_pile`` (8,192) as
   ``scripts/bench_all.py`` builds them, and both at 131,072 particles (1,024
   ropes; the pile at the bench's density on 16x the floor,
   ``scene/pbd_scenes.py``).  Each warms up until a tick has floor-active
   nodes and touching pairs, runs 3 ticks of the kernels against 3 of the
   twins from that state (positions within 1e-3; pair counts, rebuilds and
   the latch equal), then a timed ``run_ticks(10)`` with the launch counters
   reset before, gated on the device counters (live and touching pairs,
   floor-active nodes, no sim_failed): ms/tick, launches, rebuilds, pairs
   and touching pairs per tick.  Then T18-T21 against their twins at 131,072
   particles, timed beside their bounds and ``index_add_``.

11. Item 5c's paths, each window a timed ``run_ticks(10)`` with the launch
   counters reset before, gated on floor contact (and contacts), no
   sim_failed, finite positions and every kernel of its path launched,
   followed by 3 ticks of kernels against twins: 11a ``bench.py``'s soup
   under ``contact_coupling="full"`` (45 warm-up ticks, ticks 46-55; CG
   trips per solve printed), with T22's factor, T10 and T9's stage 2 with
   T23's terms and T11 with the block solve held to their twins on its
   state; 11b phase 3b's solver at tick 55 with ``tet_cols=False``: one
   tick from its state within twice the tet-column tick's own one-ulp
   spread of the tet-column tick, one CG trip per solve; 11c phase 7's
   state at its first sheet-soup contact under full coupling; 11d phase
   5's state at tick 75 with ``dense_floor=False``: T24, T9's entry mode
   and T4's count mode held to their twins, one tick from each state held
   against the dense floor's (within 1e-6 of the position scale or twice
   the dense tick's one-ulp spread).

12. Edge-edge and PD node-node contacts (T25-T27), each window a timed
   ``run_ticks(10)`` with the launch counters reset before, gated on no
   sim_failed, finite positions, the window's contact counters above 0
   (read on the device) and every kernel of its path launched, followed by
   3 ticks of kernels against twins: 12a the crossing nets of
   ``scripts/bench_all.py``'s ``edge_nets`` (nn = 24, 1,152 nodes, full
   coupling, ``reference_quirks=False``, caps 2,048), warmed tick by tick to
   the first tick with live edge contacts, the window the 10 ticks after it
   (edge contacts, hits before the cap, point-triangle contacts and CG trips
   printed per tick); 12b the same nets at nn = 256 (131,072 nodes, caps
   262,144), the same rule (or, if the latch falls in those ticks, the 10
   that end before it), with T25's contacts, order and pre-cap count held
   equal to its twin and T26's setup and its terms in T9's stage 2, T10 and
   T8 within 1 ulp, timed beside their bounds and ``index_add_``; 12c a PD
   node cloud (``add_node_pile``, 131,072 nodes, seed 3, cap 2^21), ticks
   1-10 gated on live and touching pairs, then T27 (setup, friction, its
   force in T9's stage 2, T4 with its impulse) within 1 ulp of its twin.
13. The scene ensemble (``pies_tpu_torch.parallel.ensemble``; T1-T8 with a
   member axis): ``scripts/bench_all.py``'s ``ensemble_vmap``, 64 members of
   ``create_tet_soup(512, spacing=1.6, ...)`` with self-contact (131,072
   nodes), each member's live nodes moved by a seeded offset (uniform
   +-0.02, seed = member).  45 warm-up ticks tick by tick (the layers meet
   at tick ~40), then three timed ``ensemble_tick_n(10)`` calls with the
   launch counts reset before each: ms/tick and scene-steps/s, launches per
   tick, contacts per tick and the members that have them, cache rebuilds,
   floor-active nodes.  Checks: no member latched, finite positions, live
   contacts, launches per tick equal to a batch of one's; members 0, 21, 42
   and 63 bit-equal to single-scene kernel runs from the same start, contact
   counts equal on every warm-up tick; all 64 members bit-equal to their
   single-scene kernel runs over each window, contact counts equal; one
   ensemble tick of the kernels bit-equal, at all 64 members, to the batched
   twin (each wrapper's twin member by member), and 3 ticks bit-equal at
   members 0, 21, 42 and 63 to their twins (~0.18 s a member-tick on the
   card, so not all 64 for 3).  Each batched T1-T8
   stage is timed at B = 64 beside 64 launches of it at B = 1.  13b: 4
   members of a 4,096-tet soup at spacing 1.0, member 2 latched before the
   start: after 40 ticks it is bit-unchanged and the others are in contact,
   unlatched.

14. The tet mesher, ``Solver.add_tri_mesh_volume`` and the diagnostics
   (T28, T29).  14a: ``Solver(SolverOptions(solver=PD),
   enable_collisions=True).add_tri_mesh_volume(cube * 6, tris,
   resolution=47)`` on the bench's cube (``scripts/bench_all.py:86-97``),
   meshed by the port's native mesher (built with g++ under
   ``pies_tpu_torch/_build``; the route is required): 110,592 nodes,
   622,938 tets and 26,508 surface triangles, tets and surface equal to
   ``scripts/refbench/tet_cube_mesh_100k.txt`` and points within 6e-6.
   Warm-up to the first tick with floor-active nodes (from tick 60, tick by
   tick), then a timed ``run_ticks(10)`` followed by
   ``diagnostics.solver_stats`` and ``diagnostics.broadphase_health``, the
   launch counts reset before the window and read after the diagnostics:
   gated on floor contact, no sim_failed, finite positions, every kernel of
   the path and T28, T29 launched; ms/tick, launches per tick and a traced
   window's device idle share.  14b: ``tet_cube_drop`` as
   ``scripts/bench_all.py:80-102`` builds it (the port's ``tetrahedralize``
   at 10: 1,331 nodes, 6,000 tets; radius 0.2, w 1000, collisions on), the
   same gates.  14c: T28 against its twin on 14a's state (strain, volume,
   floor, speed), phase 6's cloth (distance, bend) and the pinned 1,331-node
   mesh (pins): each key within 1e-6 relative, timed with its bound.  14d:
   T29 against its twin in its three branches (phase 3b's soup on packed
   bodies, phase 9a's box pile under all-pairs, 14a's and 14b's meshes
   under the cell list): the five words equal, and ``broadphase_health``
   equal to the twin's words on each scene.

15. Ensembles on the contact-free generic PD path (ROADMAP item 10b-i; T3,
   T9-T13, T22 and T4 with a member axis, each CG with its own exit per
   member).  15a ``tests/test_diagnostics.py:47-76`` at its size: 64 x an
   8-node rope at y = 6 (one pin, w 2000, ``StepConfig`` defaults, so
   ``cg_rtol`` 0), 10 ticks of ``ensemble_step``: ``num_failed`` 0, the max
   residual finite, member 0 equal to member 63 and every member bit-equal
   to the single-scene run.  15b 64 x ``tet_cube_drop`` (``scene/
   cube_drop.py``: the cube meshed at 10, 1,331 nodes and 6,000 tets each,
   85,184 nodes a tick, the Solver's defaults with self-contact off), each
   member lifted by its own seeded offset (up to 0.5 in y, +-0.02 jitter):
   tick by tick until every member has had floor-active nodes, then three
   timed ``ensemble_tick_n(10)`` calls (ms/tick, scene-steps/s, launches per
   tick, CG trips per solve per member), gated on floor contact in every
   member over the 30 ticks, no latch, finite positions, members 0, 21, 42,
   63 bit-equal to their single-scene runs and launches per tick equal at B
   = 64 and B = 1; an exit window with the CG cap raised to 64 trips
   (at 16 no solve of this mesh meets ``cg_rtol`` 1e-4), gated on the
   members' trip counts differing and the sampled members equal to their
   single-scene runs, trips included; a traced window's idle share and
   device time by kernel.  15c one tick of all 64 members bit-equal to the
   batched twin's, then each stage's kernel against its batched twin on
   the same inputs and timed at B against B launches at B = 1: T3, T9's two
   stages, T10 (ELL), T11 and T4 on 15b's state; T12, T13, T9 stage 2, T10
   (ELL width 9) and T11 on 8 x the 32 x 32 rigged cloth; T22, T10's band
   and T11's block solve on 4 x 4,096-tet soups with ``tet_cols=False``.
   15d 4 x ``tet_cube_drop`` with member 2 latched before the start: after
   40 ticks it is bit-unchanged and the others have stepped.
16. Ensembles on the generic PD path with point-triangle self-contact
   (ROADMAP item 10b-ii; T14-T17, T23, T24 and T7-T10 with a member axis).
   16a 64 x ``tet_cube_drop`` with the bench's self-contact (the super-body
   detection, T14/T15) and 16b 64 x phase 9a's box pile (all-pairs,
   T16/T17), each member jittered: three timed ``ensemble_tick_n(10)``
   windows from the floor contact, gated on no latch, floor contact in
   every member, the detection's kernels launched and launches per tick
   equal at B = 64 and B = 1 (16b: contacts in every member), and a traced
   window.  16c every stage of the substep (``solver/stages.py``) at B = 3
   with a latched member bit-equal to its twins' member loop on the
   kernels' inputs, B = 1 equal to the unbatched call, and each kernel
   timed at B = 64 against 64 launches at B = 1: on 16a's and 16b's states,
   16b's under full coupling on the entry-list floor (T23, T24), the
   cell-list and reference branches on phase 9b's folded mesh and the
   per-body branch on phase 2b's soup (64 x 110,592 and 64 x 500,000
   nodes); then every branch and term through the ensemble tick on small
   scenes.  16d members 0, 21, 42, 63 bit-equal to their single-scene
   runs, and one tick of 64 members of 16b (8 of 16a) to the batched twin.
   16e a member latched before the start stays bit-unchanged over 40 ticks.
17. Ensembles on the generic PD path with edge-edge and PD node-node
   contacts (ROADMAP item 10b-iii; T20, T25, T26 and T27 with a member
   axis, T26's and T27's terms inside T8, T9 and T10 per member).  17a 64 x
   ``edge_nets`` at the bench's nn = 24 (``scene/edge_nets.nets_ensemble``:
   1,152 nodes and 2,116 triangles a member, full coupling, caps 2,048),
   each member jittered; a probe of 110 ticks gives each member's first
   edge-contact tick and latch tick, and the three timed
   ``ensemble_tick_n(10)`` windows run from tick 48, or earlier so that
   they end before the first latch, gated on no latch, finite positions,
   edge contacts in every member (device counters), the detection's
   kernels launched and launches per tick equal at B = 64 and B = 1, then
   a traced window.  17b 64 PD node clouds (``scene/pbd_scenes.
   cloud_ensemble``: ``add_node_pile`` at 8,192 nodes, cap 16 a node), the
   same from the tick at which every member has touching pairs, gated on
   node pairs and touching pairs in every member.  17c every stage
   (``solver/stages.py``: T16's edge candidates, T25, T26's setup, T9 and
   T10 with T26's terms, T8's edge pass; T20, T27's setup and friction, T9
   with the pair force) at B = 3 with a latched member bit-equal to its
   twins' member loop and B = 1 to the unbatched call, on 17a's state in
   both quirk modes, 17b's and the tet boxes with all three contact
   families under recentered coupling; each timed at B = 64 against 64
   launches at B = 1 on 17a's and 17b's states and at B = 4 on phase 12b's
   full-width nets.  17d members 0, 21, 42, 63 bit-equal to their
   single-scene runs over each window, one tick of 8 members of 17a and of
   17b bit-equal to the batched twin, and on 4 x the 6 x 6 nets with
   node-node contacts on too a member latched before the start
   bit-unchanged over 40 ticks.
18. PBD ensembles (ROADMAP item 10b-iv; T18, T19 and T21 with a member
   axis, T20's node-pair cache kept per member across ticks), at
   ``scripts/bench_all.py``'s sizes, each member jittered by ±0.02
   (``scene/pbd_scenes.py``): 18a 64 x ``rope_pbd`` (16 pinned ropes of
   128, collisions on: 131,072 nodes a tick; the chain walk), 18b 64 x
   ``pbd_node_pile`` (8,192 nodes: 524,288 a tick), 18c 64 x
   ``ensemble_vmap``'s 512-tet soup under the PBD solver, collisions off,
   ``reference_quirks=False``, strain weight 1.0 (``PBD_SOUP``).  Each is
   warmed tick by tick until every member has had floor-active nodes (18a,
   18b: and touching pairs;
   the per-tick rebuild counts of 18b's members must differ on some tick:
   one member reuses its cache while another rebuilds in the same launch),
   then three timed ``ensemble_tick_n(10)`` windows gated on no latch,
   finite positions, floor-active nodes in every member (18a: touching and
   live pairs in every member and floor-active nodes in all, since a
   swinging rope meets the floor now and then; 18b: touching pairs in
   every member too), the path's kernels launched and launches per tick
   equal at B = 64 and B = 1, and a traced window.  18d
   every stage of ``solver/stages.pbd_stages`` at B = 3 (member 1
   latched) bit-equal to its twins' member loop on the kernels' inputs
   (bend rows within 1e-6) and B = 1 to the unbatched call, on 18a's,
   18b's and 18c's states (18c's in both quirk modes), the 8 x 8 net
   (colour classes) and ``create_bend_sheet``; each stage timed at B = 64
   against 64 launches at B = 1 on 18a's, 18b's and 18c's states.  18e
   members 0, 21, 42, 63 bit-equal to their single-scene runs over each
   window, caches and counters included, and one tick of 8 members of each
   bit-equal to the batched twin.  18f 4 x ``rope_pbd`` with member 2
   latched before the start: bit-unchanged over 40 ticks, counting nothing.
19. Tet-column ensembles with self-contact off the packed bodies (ROADMAP
   item 10c): 64 x phase 13's 512-tet soup (±0.02 jitter) in reference
   mode ("19 reference": T16/T17's reference sweep) and with a budget that
   unpacks the bodies ("19 celllist": body stride 1, 32 narrow slots, the
   super-body layout off), each after 45 warm-up ticks: three timed
   ``ensemble_tick_n(10)`` windows gated on no latch, finite positions,
   floor contact in every member, T16/T17 launched and launches per tick
   equal at B = 64 and B = 1, members 0, 21, 42, 63 bit-equal to their
   single-scene runs over the 30 ticks, a traced window; then every stage
   (T3, T16/T17, T7, T1, T2, T8, T4) at B = 3 with member 1 latched equal
   to its twin for members 0 and 2, member 1 frozen.
20. The spatial domain decomposition on one card (ROADMAP item 11a; T30
   ``halo.cu``, and T3, T4, T9-T13, T7, T8 and T27 in their
   accumulate-only modes, T16/T17, T25 and T20 with their emit masks, T11
   over the owned nodes): 20a phase 5's mesh at tick 75 in 8 slabs (floor
   contact), 20b phase 3b's soup at tick 55 with self-contact in 4 (the
   cell list, 32 narrow slots), 20c a PD node cloud of 131,072 in 4 (phase
   12c's, sparser: ``CLOUD_DENSITY``), 20d ``edge_nets`` at nn = 24 in 2
   (from the single scene's first edge contact, before the dense phase and
   any latch); a refused slab count falls back to
   the largest one below it that the partitioner accepts.  Each: the
   slabs' contact counts (20c: touching node pairs) summed equal to the
   single scene's on identical inputs, one domain tick within 1e-5 of the
   single scene's on the generic path with Jacobi (20c: printed), three
   timed 10-tick windows beside the single scene's ms/tick, the path's
   kernels launched, launches per tick and a traced window's idle share and
   T30 share.  20e two domain ticks by the kernels bit-equal to the twins'
   on a 16,384-tet soup, an 8,192-node cloud at 20c's density and the nets
   at 3 and 8 slabs (or the largest accepted), and T30's refresh, reduce (sum, p·Ap
   partials, average, apply) and merge equal to their twins and timed on
   20a's shapes beside ``index_select`` / ``index_add_``.  20f a NaN in one
   slab latches every slab, and the next tick leaves the state bit for bit.
21. The domain decomposition and the ensembles across ``torch.distributed``
   ranks (ROADMAP item 11b): four gloo ranks on the one card (NCCL refuses
   two ranks on one device), started once with ``ranks.launch`` after
   phase 1 built the kernels, so that each rank only loads the library.
   21a phase 13's ensemble from its last tick, 16 members a rank, 10
   sharded steps: every member bit-equal to the one-process ensemble's,
   the fleet's residual and latched count equal on every tick; ms/tick per
   rank, launches per tick.  21b phase 20a's mesh in 8 slabs (two a rank)
   and phase 20b's soup with self-contact in 4 (every halo across ranks):
   T30's outer-band modes bit-equal to their twins at the rank's shapes;
   the operator across the ranks on one seeded vector bit-equal to phase
   20's one-card operator, its p·Ap total within 1e-5 of the float64 dot;
   one tick within the bound phase 20 held the slabs to, and within 1e-5
   of phase 20's one-card domain tick; a rerun of it bit-identical on every
   rank; three timed 10-tick windows beside phase 20's one-card ms/tick;
   the CG across the ranks (T11's split partials) by the kernels bit-equal
   to the twins', and its time a solve (collectives included); T11's
   update and direction alone on rank 0, their partials at the last rank's
   slice of R·P, bit-equal to their twin and timed a trip; the exchange's
   and the gather's time a call.  21c a NaN in one rank's slab latches
   every rank on that substep, and the next tick leaves every rank's state
   bit for bit.  A rank that fails ends the others and the script.

Each phase prints its seconds.  The last two lines are the kernel table
and the result as JSON objects.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

N_TETS = 125_000
SCENE = dict(spacing=1.6, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
DENSE_SCENE = dict(SCENE, spacing=1.0)
# The soup under PBD (phase 18c): a PBD weight is the fraction of a
# projection applied, so the PD stiffness 2000 overshoots 2000-fold and the
# first tick goes non-finite; 1.0 applies each tet's projection in full.
PBD_SOUP = dict(SCENE, w=1.0)
FLOOR_WARMUP = 30  # the bench soup's bottom layer reaches the floor at tick ~25
CONTACT_WARMUP = 45  # its layers start touching at tick ~40
# The kernels-line row of T2's contact substep (one cooperative launch, T7's
# force inside), the main path's form (phase 2b times it, 3b launches it).
T2_CONTACT = "tet_cols_substep (contact substep)"
MESH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "refbench")
MESH_BIG = os.path.join(MESH_DIR, "tet_cube_mesh_100k.txt")
MESH_SMALL = os.path.join(MESH_DIR, "tet_cube_mesh.txt")
MESH_WARMUP = 75  # the big mesh falls 3.0 units: its bottom meets the floor at tick 70
SMALL_PINS = (0, 10, 110, 120)  # the corners of the small mesh's x = 0 face
CLOTH_N = 512  # the rigged cloth's lattice side
CLOTH = dict(scale=0.1, height=0.3, w=5000.0)
CLOTH_TURN = 0.05  # radians the fixed region is turned by before the window
N_BLOBS = 4096
MIXED_SHEET = 100  # the full mixed scene's sheet side (its soup has N_TETS tets)
MIXED_FREE_FALL = 35  # ticks before sheet and soup can touch (they do from tick ~40)
SMALL_SHEET = 32
PBD_BIG = 131_072  # the PBD cells' full width
PBD_BENCH = (2048, 8192)  # rope_pbd, pbd_node_pile at bench_all.py's sizes
PBD_ROWS = ("pbd_constraints", "pbd_distance_seq", "node_pairs", "node_response")
NETS_NN = 24  # the edge_nets cell's nets (bench_all.py:221)
NETS_BIG = 256  # two 256 x 256 nets: 131,072 nodes, the PBD cells' width
CLOUD_N = 131_072  # the PD node cloud
ENS_MEMBERS, ENS_TETS = 64, 512  # ensemble_vmap's scenes (bench_all.py:314-333)
ENS_SAMPLED = (0, 21, 42, 63)  # members held to their single-scene runs
ENS_SMALL = 4096  # tets of each member of phase 13b's latch ensemble
ENS_ROPE = 64  # phase 15a: tests/test_diagnostics.py:47-76's ensemble
ENS_DROP = 64  # phase 15b: members of tet_cube_drop
ENS_CLOTH = (32, 8)  # phase 15c: the rigged cloth's side and members
ENS_BLOCK = (4096, 4)  # phase 15c: the soup's tets and members, tet_cols=False
ENS_PILE = 64  # phase 16b: members of the box pile
PILE_WARM = 30  # the piled boxes touch from tick ~27
# Phase 16c's small scenes (scene/contact_piles.py branch_scene): the tet
# boxes in contact from tick ~5, the 24-tet soup's tets from tick 32.
BRANCH_WARM = {"super": 6, "celllist": 6, "reference": 6, "bodies": 31, "full_entry": 6}
CONTACT_PATHS = ("16a", "16b", "16c super", "16c celllist", "16c reference", "16c bodies",
                 "16c full_entry")
ENS_NETS = 64  # phase 17a: members of edge_nets
ENS_CLOUD = (8192, 64)  # phase 17b: nodes of each PD node cloud (bench_all.py:168-175), members
ENS_BIG = 4  # phase 17c: members of phase 12b's full-width nets
NETS_DENSE = 48  # the bench's nets have dense edge contacts from tick ~48
NETS_PROBE = 110  # phase 17a's probe, past the window and the single scene's latch (tick 72)
ALL_ON_WARM = 10  # the tet boxes have all three contact families live from tick ~10
EDGE_PATHS = ("17a", "17b", "17c all_on")
ENS_PBD = 64  # phase 18: members of each PBD ensemble
PBD_PATHS = ("18a", "18b", "18c")
DOMAIN_PATHS = ("20a", "20b", "20c", "20d")
CLOUD_DENSITY = 0.02  # phase 20c's nodes per unit volume (the pile's 5.5 units high)
# Phase 14: the bench's cube (scripts/bench_all.py:86-97, its +0.5 lift in y
# applied), meshed at 47 cells across and scaled by 6 (the dump MESH_BIG's
# geometry; its bottom at y = 3), and at 10 for tet_cube_drop.
CUBE_VERTS = ((0, 0.5, 0), (2, 0.5, 0), (2, 2.5, 0), (0, 2.5, 0),
              (0, 0.5, 2), (2, 0.5, 2), (2, 2.5, 2), (0, 2.5, 2))
CUBE_TRIS = ((0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
             (1, 2, 6), (1, 6, 5), (2, 3, 7), (2, 7, 6), (3, 0, 4), (3, 4, 7))
MESH_RES, MESH_SCALE = 47, 6.0
DROP_RES = 10

# The H100 SXM's published peaks (NVIDIA's datasheet): the least time
# of a kernel is the larger of its bytes over the memory rate and its float32
# operations over the non-tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def run(cmd):
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    return (p.stdout + p.stderr).strip()


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    """``(bound_ms, bound_by)`` from the bytes a call must move and the
    float32 operations it must do."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_ulp(a, b):
    """Largest difference in units of the last place of float32 tensors."""
    import torch

    a, b = a.float(), b.float()
    m = torch.maximum(a.abs(), b.abs())
    ulp = torch.nextafter(m, torch.full_like(m, float("inf"))) - m
    d = (a - b).abs() / ulp
    return float(torch.where(a == b, torch.zeros_like(d), d).max()) if d.numel() else 0.0


def clone_state(s):
    from pies_tpu_torch.state import clone_state as clone

    return clone(s)


def check(ok, what):
    if not ok:
        raise SystemExit(f"FAILED: {what}")
    print(f"  ok: {what}")


def kernel_wrappers() -> dict:
    """Each kernel's wrappers, by the name of its row: their ``launches``
    counts are what the script resets before a path and reads after it."""
    from pies_tpu_torch import diagnostics
    from pies_tpu_torch.collision import broadphase
    from pies_tpu_torch.constraints import projections as proj
    from pies_tpu_torch.parallel import halo
    from pies_tpu_torch.solver import assembly, pbd, pd, tetcols

    return {"substep_head": [pd.substep_head], "tet_force12": [proj.tet_force12],
            "tet_cols_substep": [tetcols.substep_cols, tetcols.contact_substep],
            "substep_tail": [pd.substep_tail],
            "body_broadphase": [broadphase.body_broadphase],
            "pt_narrowphase": [broadphase.pt_narrowphase],
            "pt_coupling": [tetcols.pt_coupling_setup, tetcols.pt_force],
            "pt_tail": [pd.pt_tail],
            "tet_force_nodes": [proj.tet_force12_gathered, assembly.assemble_force],
            "ell_matvec": [assembly.apply_system], "pcg": [assembly.pcg_solve],
            "constraint_rows": [proj.distance_rows, proj.bend_rows],
            "shape_match": [proj.shape_rows, proj.goal_rows],
            "super_broadphase": [broadphase.super_broadphase],
            "super_narrowphase": [broadphase.super_narrowphase],
            "tri_candidates": [broadphase.tri_candidates], "tri_ccd": [broadphase.tri_ccd],
            "pbd_constraints": [pbd.substep_head, proj.jacobi_rows, pbd.apply_jacobi,
                                pbd.floor_clamp, pbd.substep_tail],
            "pbd_distance_seq": [pbd.chain_scan, pbd.color_classes],
            "node_pairs": [broadphase.node_pairs], "node_response": [broadphase.node_response],
            "tet_block": [assembly.tet_block_factor], "pt_full": [assembly.pt_full],
            "floor_entries": [pd.floor_entries], "edge_ccd": [broadphase.edge_ccd],
            "edge_terms": [assembly.edge_terms], "node_contacts": [assembly.node_terms],
            "residuals": [diagnostics.constraint_residuals],
            "occupancy": [broadphase.occupancy], "halo_refresh": [halo.refresh],
            "halo_reduce": [halo.reduce], "halo_merge": [halo.merge, halo.merge_pairs]}


def mesh_solver(pt, path, dev, pins=(), collisions=False):
    """A solver on an imported mesh dump (w = 1000, radius 0.2), with
    ``pins`` held by position constraints of weight 8000."""
    from pies_tpu_torch.scene.mesh_dump import add_tet_mesh, load_mesh_txt

    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), enable_collisions=collisions,
                  device=dev)
    add_tet_mesh(s, *load_mesh_txt(path), pins=pins)
    return s


def blob_solver(pt, n_bodies, dev):
    """``n_bodies`` shape-matching boxes of 5 x 5 x 5 nodes on a grid, each
    with a seeded velocity, and a seeded spin of each body about its centre
    written to the state."""
    import numpy as np
    import torch

    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), enable_collisions=False,
                  device=dev)
    rng = np.random.default_rng(2)
    side = int(np.ceil(n_bodies ** 0.5))
    vel = rng.uniform(-1.0, 1.0, (n_bodies, 3)).astype(np.float32)
    for b in range(n_bodies):
        i, j = divmod(b, side)
        s.create_shape_matching_box((3.0 * i, 1.0 + 0.5 * (b % 3), 3.0 * j), 5, 5, 5, 1.0,
                                    tuple(vel[b]), 4000.0)
    st = s.state
    n = 125 * n_bodies
    pos = st.positions[:n].view(n_bodies, 125, 3)
    omega = torch.from_numpy(rng.uniform(-2.0, 2.0, (n_bodies, 1, 3)).astype(np.float32)).to(dev)
    spin = torch.linalg.cross(omega.expand(-1, 125, -1), pos - pos.mean(dim=1, keepdim=True))
    st.velocities[:n] += spin.reshape(n, 3)
    return s


def phase13(pt, dev, smi, PD, rows, launches, reset_launches, read_launches, path,
            members=ENS_MEMBERS, n_tets=ENS_TETS, small_tets=ENS_SMALL):
    """Phase 13: the ``ensemble_vmap`` cell (``scripts/bench_all.py:314-333``),
    ``members`` soups of ``n_tets`` tets with self-contact under one tick;
    13b a small ensemble with a member latched before the start."""
    import numpy as np
    import torch

    from pies_tpu_torch.collision import broadphase
    from pies_tpu_torch.constraints import projections as proj
    from pies_tpu_torch.parallel import ensemble
    from pies_tpu_torch.solver import pd, step, tetcols
    from pies_tpu_torch.state import member, stack_ensemble, unstack

    def soup(n, scene, b):
        """A prepared soup and its ensemble of ``b`` members, each member's
        live nodes moved by its own offset (uniform +-0.02, seed = member)."""
        s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, device=dev)
        s.create_tet_soup(n, **scene)
        s._prepare()
        states = stack_ensemble(s.state, b)
        live = s._builder.num_nodes
        for m in range(b):
            off = np.random.default_rng(m).uniform(-0.02, 0.02, (live, 3)).astype(np.float32)
            off = torch.from_numpy(off).to(dev)
            states.positions[m, :live] += off
            states.prev_positions[m, :live] += off
        return s, states

    fields = ("positions", "prev_positions", "velocities", "forces", "sim_failed")

    def same(a, b):
        """Bit-equal states (the cache included)."""
        return (all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
                and all(torch.equal(getattr(a.bp, f), getattr(b.bp, f))
                        for f in ("pairs", "valid", "ref", "fresh")))

    t_phase = time.perf_counter()

    def lap(what):
        print(f"  ({what}: {time.perf_counter() - t_phase:.1f} s into phase 13)")

    s, states = soup(n_tets, SCENE, members)
    topo, params, cfg = s.topology, s.current_params(), s.config
    live = s._builder.num_nodes
    print(f"phase 13: ensemble_vmap, {members} x {n_tets}-tet soups with self-contact,"
          f" {members * s.state.capacity} nodes, {CONTACT_WARMUP} warm-up ticks tick by tick")
    sampled = [b for b in ENS_SAMPLED if b < members]
    singles = {b: unstack(states, b) for b in sampled}
    ens_counts, single_counts = [], {b: [] for b in sampled}
    for _ in range(CONTACT_WARMUP):
        c = pd.new_counters(dev, members)
        ensemble.ensemble_tick(states, topo, params, cfg, counters=c)
        ens_counts.append(c["contacts"].tolist())
        for b, sb in singles.items():
            cb = pd.new_counters(dev)
            step.tick(sb, topo, params, cfg, counters=cb)
            single_counts[b].append(int(cb["contacts"]))
    check(all(single_counts[b] == [r[b] for r in ens_counts] for b in sampled),
          f"members {sampled}: contact counts equal their single-scene kernel runs on each of"
          f" ticks 1-{CONTACT_WARMUP} (member 0: {single_counts[0][-6:]} over the last 6)")
    check(all(same(member(states, b), singles[b]) for b in sampled),
          f"members {sampled} bit-equal to their single-scene runs at tick {CONTACT_WARMUP}")

    lap("warm-up")
    del singles
    # Three timed windows of ensemble_tick_n(10), the launch counts reset
    # before each; every member's single-scene run from the window's start
    # follows it (B = 1 launches, which earlier phases hold to the twins).
    for w in range(3):
        first = CONTACT_WARMUP + 10 * w + 1
        starts = [unstack(states, b) for b in range(members)]
        reset_launches()
        c = pd.new_counters(dev, members)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ensemble.ensemble_tick_n(states, topo, params, cfg, 10, counters=c)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / 10
        launches["13"] = read_launches()
        counts = {k: v.tolist() for k, v in c.items()}
        per_tick = sum(launches["13"][n] for n in path) / 10
        contacts = counts["contacts"]
        with_contacts = sum(v > 0 for v in contacts)
        print(f"  window {w + 1}: {sec * 1e3:.3f} ms/tick, {members / sec:.1f} scene-steps/s"
              f" ({smi}; ticks {first}-{first + 9}; max residual {float(res):.4g});"
              f" {per_tick:.1f} launches per tick; contacts {sum(contacts) / 10:.1f} per tick"
              f" in {with_contacts} of {members} members; cache rebuilds {sum(counts['rebuilds'])};"
              f" floor-active node-substeps {sum(counts['floor_active'])}")
        apart = []
        for b, sb in enumerate(starts):
            cb = pd.new_counters(dev)
            step.tick_n(sb, topo, params, cfg, 10, counters=cb)
            if int(cb["contacts"]) != contacts[b] or not same(member(states, b), sb):
                apart.append(b)
        check(not apart, f"all {members} members bit-equal to their single-scene kernel runs"
              f" over ticks {first}-{first + 9}, contact counts equal (apart: {apart})")
        del starts
    pos = states.positions[:, :live]
    n_failed = int((states.sim_failed != 0).any(dim=-1).sum())
    check(n_failed == 0 and bool(torch.isfinite(pos).all()),
          "no member latched, all positions finite")
    check(sum(contacts) > 0, f"live contacts in the window: {with_contacts} members")
    check(all(launches["13"][n] > 0 for n in path), f"every kernel launched: {launches['13']}")
    one = stack_ensemble(unstack(states, 0), 1)
    reset_launches()
    ensemble.ensemble_tick_n(one, topo, params, cfg, 10)
    torch.cuda.synchronize()
    launches["13 B=1"] = read_launches()
    check(launches["13 B=1"] == launches["13"],
          f"launches per tick at B = {members} equal those at B = 1: {per_tick:.1f}")

    lap("windows")
    # The batched twin (each wrapper's twin run member by member) for one
    # tick at B = members, then the sampled members' twins for 3 ticks
    # (~0.18 s a member-tick on the card, so not all members for 3).
    print(f"phase 13: the kernels at B = {members} against the batched twin for 1 tick and"
          f" against members {sampled}' twins for 3 ticks")
    e, p = clone_state(states), clone_state(states)
    c, cp = pd.new_counters(dev, members), pd.new_counters(dev, members)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ensemble.ensemble_tick(e, topo, params, cfg, counters=c)
    torch.cuda.synchronize()
    sec_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    step.tick(p, topo, params, cfg, plain=True, counters=cp)
    torch.cuda.synchronize()
    sec_p = time.perf_counter() - t0
    apart = [b for b in range(members) if not same(member(e, b), member(p, b))]
    check(not apart and all(torch.equal(c[k], cp[k]) for k in c),
          f"tick 1: all {members} members' states, caches and counters bit-equal to the batched"
          f" twin's ({int(c['contacts'].sum())} contacts; apart: {apart})")
    print(f"  kernels {sec_k * 1e3:.3f} ms per ensemble tick ({members} members), batched twin"
          f" {sec_p * 1e3:.3f} ms ({smi})")
    del p
    ensemble.ensemble_tick_n(e, topo, params, cfg, 2, counters=c)
    for b in sampled:
        sb, cb = unstack(states, b), pd.new_counters(dev)
        step.tick_n(sb, topo, params, cfg, 3, plain=True, counters=cb)
        check(same(member(e, b), sb) and all(int(cb[k]) == int(c[k][b]) for k in cb),
              f"member {b}: state, cache and counters bit-equal to its twins' after 3 ticks"
              f" ({int(cb['contacts'])} contacts)")
    del e
    lap("kernels against twins")

    # Each batched stage at B = members against `members` launches of it at
    # B = 1 on the members' views, on this state's next substep.
    st = clone_state(states)
    x, msn, diag, wf, active = pd.substep_head(st, topo, params, cfg, False)
    tmask, lay = topo.tri_mask, broadphase.body_layout(cfg, topo.tri_mask.shape[0])
    sc = broadphase.scalars(params)
    ov = torch.zeros((members, 1), dtype=torch.int32, device=dev)
    colls = pd.detect_point_tri(st, x, topo, params, cfg, active)
    _, h2 = pd._h_h2(params)
    inc, ptd = tetcols.pt_coupling_setup(colls, st.mass, topo, h2, diag, wf, st.sim_failed)
    thick = params.collision_thickness
    contact = tetcols.pt_force(x, colls, inc, thick, st.sim_failed)
    plane = pd.floor_plane(params, cfg.reference_quirks)
    pt_args = (ptd, contact, inc.row_start, colls.pt_count)
    x_new, stat, _ = tetcols.substep_cols(x, msn, diag, st.node_mask, wf, topo, plane, 1,
                                          st.sim_failed, pt_args)
    fric = pd.pt_tail(st, params, cfg, colls, inc, x_new, stat)
    torch.cuda.synchronize()
    n_contacts = int(colls.pt_count.sum())
    mv = lambda *a: [tuple(member(t, b) for t in a) for b in range(members)]  # noqa: E731
    stages = {
        "substep_head": (lambda st_, *_: pd.substep_head(st_, topo, params, cfg, False),
                         (st,), 76 * members * st.capacity, 17 * members * st.capacity),
        "body_broadphase": (
            lambda x_, p_, c_, o_, f_: broadphase.body_broadphase(x_, p_, tmask, c_, lay, sc,
                                                                  o_, f_),
            (x, st.prev_positions, st.bp, ov, st.sim_failed),
            members * (48 * lay.k * lay.m + 4 * lay.k * lay.e + 8 * lay.lanes), members * 1000
            * lay.k),
        "pt_narrowphase": (
            lambda x_, p_, c_, o_, f_: broadphase.pt_narrowphase(x_, p_, tmask, c_, lay, sc,
                                                                 o_, f_),
            (x, st.prev_positions, st.bp, ov, st.sim_failed),
            members * (24 * lay.k * lay.m + 4 * lay.k * lay.e + 4 * lay.lanes + 20 * lay.cap),
            members * 864 * lay.lanes),
        "pt_coupling": (
            lambda c_, m_, d_, w_, x_, f_: tetcols.pt_force(
                x_, c_, tetcols.pt_coupling_setup(c_, m_, topo, h2, d_, w_, f_)[0], thick, f_),
            (colls, st.mass, diag, wf, x, st.sim_failed),
            2 * (20 * n_contacts + 24 * 4 * n_contacts), 50 * 4 * n_contacts),
        "tet_force12": (lambda x_, f_: proj.tet_force12(x_, topo.strain, topo.volume, f_),
                        (x, st.sim_failed), 204 * members * lay.k, 1500 * members * lay.k),
        "tet_cols_substep": (
            lambda x_, m_, d_, k_, w_, f_, p_: tetcols.substep_cols(
                x_, m_, d_, k_, w_, topo, plane, 1, f_, p_),
            (x, msn, diag, st.node_mask, wf, st.sim_failed, pt_args),
            424 * members * (st.capacity // 4), 1600 * members * (st.capacity // 4)),
        "pt_tail": (lambda s_, c_, i_, x_, sp_: pd.pt_tail(s_, params, cfg, c_, i_, x_, sp_),
                    (st, colls, inc, x_new, stat),
                    cfg.collision_stabilization_iterations * 84 * n_contacts + 76 * n_contacts,
                    cfg.collision_stabilization_iterations * 60 * n_contacts + 90 * n_contacts),
        "substep_tail": (
            lambda s_, a_, x_, sp_, c_, i_, fr_: pd.substep_tail(s_, topo, params, a_, x_, sp_,
                                                                c_, i_, fr_),
            (st, active, x_new, stat, colls, inc, fric), 120 * members * st.capacity,
            25 * members * st.capacity),
    }
    print(f"phase 13: each batched stage at B = {members} against {members} launches at B = 1"
          f" ({n_contacts} contacts on this substep; {smi})")
    for name, (fn, args, nbytes, ops) in stages.items():
        per = mv(*args)
        if name == "body_broadphase":  # a rebuild, forced
            batched = lambda: (st.bp.fresh.zero_(), fn(*args))  # noqa: E731
            looped = lambda: (st.bp.fresh.zero_(), [fn(*p) for p in per])  # noqa: E731
        else:
            batched = lambda: fn(*args)  # noqa: E731
            looped = lambda: [fn(*p) for p in per]  # noqa: E731
        ms_b, ms_1 = cuda_ms(batched, 20), cuda_ms(looped, 5)
        b_ms, b_by = bound(nbytes, ops)
        print(f"  {name}: B = {members} {ms_b:.4f} ms, {members} x B = 1 {ms_1:.4f} ms"
              f" ({ms_1 / ms_b:.1f}x), bound {b_ms:.4f} ms ({b_by})")
        if name in rows:
            rows[name].update(ensemble_b64_ms=ms_b, ensemble_b1x64_ms=ms_1,
                              ensemble_bound_ms=b_ms, ensemble_bound_by=b_by)
    handoff = (states, topo, params, cfg)  # (phase 21 starts from it)
    del st, colls, inc, s, states
    lap("stages")

    # 13b: a member latched before the start stays frozen while the others
    # step through contact.
    s4, e4 = soup(small_tets, DENSE_SCENE, 4)
    e4.sim_failed[2, 0] = 1
    start = unstack(e4, 2)
    c = pd.new_counters(dev, 4)
    ensemble.ensemble_tick_n(e4, s4.topology, s4.current_params(), s4.config, 40, counters=c)
    contacts = c["contacts"].tolist()
    latched = (e4.sim_failed != 0).any(dim=-1).tolist()
    print(f"phase 13b: 4 x {small_tets}-tet soups at spacing 1.0, member 2 latched before the"
          f" start, 40 ticks: contacts {contacts}, latched {latched}")
    check(same(member(e4, 2), start), "the latched member is bit-unchanged, its cache too")
    check(latched == [False, False, True, False] and contacts[2] == 0
          and min(contacts[:2] + contacts[3:]) > 0
          and bool(torch.isfinite(e4.positions).all()),
          "the others step through contact, unlatched and finite")
    lap("13b")
    return handoff


def phase12(pt, dev, smi, PD, row, launches, reset_launches, read_launches, kernels_vs_twins,
            nets_nn, nets_big, cloud_n):
    """Phase 12: the crossing nets at the bench's size (12a) and at full
    width (12b), and a PD node cloud (12c); T25-T27 against their twins on
    12b's and 12c's states."""
    import collections

    import torch

    from pies_tpu_torch.collision import broadphase
    from pies_tpu_torch.collision.batches import incident
    from pies_tpu_torch.scene.edge_nets import BENCH_CAPS, add_crossing_nets, solver_args
    from pies_tpu_torch.scene.pbd_scenes import add_node_pile
    from pies_tpu_torch.solver import assembly, pd, tetcols

    def nets(nn, caps):
        s = pt.Solver(pt.SolverOptions(solver=PD), device=dev, **solver_args(caps))
        return add_crossing_nets(s, nn)

    def tick_counts(s):
        c = pd.new_counters(dev)
        s.counters = c
        s.run_ticks(1)
        s.counters = None
        return {k: int(v) for k, v in c.items()}

    def path_names(s):
        """The wrappers the nets' path launches."""
        tri = broadphase.tri_mode(s.config, s.topology.triangles.shape[0])
        detect = ["tri_candidates", "tri_ccd"] if tri else ["super_broadphase",
                                                             "super_narrowphase"]
        return ["substep_head"] + detect + ["pt_coupling", "edge_ccd", "edge_terms",
                                            "constraint_rows", "tet_force_nodes", "ell_matvec",
                                            "pcg", "pt_full", "pt_tail", "substep_tail"]

    def contact_window(label, s, names, first_tick, gate):
        """A timed ``run_ticks(10)`` with the launch counts reset before it;
        checks no latch, finite positions, the window's contact counters
        (``gate``: counter names that must be above 0) and every kernel of
        the path launched."""
        reset_launches()
        c = pd.new_counters(dev)
        s.counters = c
        t0 = time.perf_counter()
        s.run_ticks(10)
        sec = (time.perf_counter() - t0) / 10
        s.counters = None
        counts = {k: int(v) for k, v in c.items()}
        launches[label] = read_launches()
        pos = s.state.positions[: s._builder.num_nodes]
        check(not s.sim_failed and bool(torch.isfinite(pos).all()),
              "no sim_failed, all positions finite")
        check(all(counts[g] > 0 for g in gate),
              f"contacts in the window: {', '.join(f'{g} {counts[g]}' for g in gate)}")
        check(all(launches[label][n] > 0 for n in names),
              f"every kernel of the path launched: {launches[label]}")
        cf = s.config
        solves = 10 * cf.time_substeps * cf.iterations
        per_tick = {n: launches[label][n] / 10 for n in names}
        print(f"  kernels: {sec * 1e3:.3f} ms/tick, {1.0 / sec:.2f} steps/s ({smi}; ticks"
              f" {first_tick}-{first_tick + 9}; {counts['cg_trips'] / solves:.2f} CG trips per"
              f" solve; counters {counts}; launches per tick {per_tick})")
        return counts

    def nets_phase(label, nn, caps, limit):
        """Warm the nets tick by tick to their first tick with live edge
        contacts, then the window of the 10 ticks after it (or, if the
        latch falls inside those, the 10 ticks that end before it), the
        window's ticks one by one, and 3 ticks of kernels against twins.
        Returns the solver at the window's end and that tick."""
        t0 = time.perf_counter()
        s = nets(nn, caps)
        s._prepare()
        print(f"phase {label}: the crossing nets, nn = {nn}: {s._builder.num_nodes} nodes,"
              f" {s.topology.triangles.shape[0]} triangles,"
              f" {s.topology.distance.idx.shape[0]} distance constraints, caps {caps}"
              f" (set-up {time.perf_counter() - t0:.2f} s)")
        after = collections.deque(maxlen=21)  # (tick, state after it)
        after.append((0, clone_state(s.state)))
        first = None
        for t in range(1, limit + 1):
            c = tick_counts(s)
            after.append((t, clone_state(s.state)))
            check(not s.sim_failed, f"no latch before the first edge contact (tick {t})")
            if c["edge_contacts"] > 0:
                first = t
                break
        check(first is not None, f"edge contacts within {limit} ticks")
        print(f"  first edge contacts at tick {first}")
        per_tick = []
        latch = None
        for t in range(first + 1, first + 11):
            c = tick_counts(s)
            after.append((t, clone_state(s.state)))
            per_tick.append((t, c))
            if s.sim_failed:
                latch = t
                break
        start = first if latch is None else latch - 11
        states = dict(after)
        check(start in states, f"the window's start state is kept (tick {start})")
        if latch is not None:
            print(f"  the latch falls at tick {latch}: the window is ticks {start + 1}-"
                  f"{start + 10}, the 10 that end before it")
        for t, c in per_tick:
            print(f"  tick {t}: edge contacts {c['edge_contacts']}, edge hits {c['edge_hits']},"
                  f" point-triangle contacts {c['contacts']}, CG trips {c['cg_trips']}")
        warm = states[start]
        s._state = clone_state(warm)
        contact_window(label, s, path_names(s), start + 1, ("edge_contacts",))
        kernels_vs_twins(s, warm)
        return s, start + 10

    # 12a: the bench's size; then on to the latch (or tick 120), for where
    # the dense contact phase, the cap and the latch fall.
    s, tick = nets_phase("12a", nets_nn, BENCH_CAPS, 120)
    dense = capped = latch = None
    while tick < 120 and latch is None:
        c = tick_counts(s)
        tick += 1
        if dense is None and c["edge_contacts"] >= 100:
            dense = tick
        if capped is None and c["edge_contacts"] >= BENCH_CAPS:
            capped = tick
        if s.sim_failed:
            latch = tick
    print(f"  after the window, up to tick {tick}: 100 or more edge contacts from tick"
          f" {dense}, the cap of {BENCH_CAPS} reached at tick {capped}, the latch at tick"
          f" {latch} (None: not reached)")
    del s
    # 12b: full width, caps x 128.
    s, _ = nets_phase("12b", nets_big, BENCH_CAPS * 128, 120)
    # (phase 17c times its ensemble's stages on this state)
    nets12b = (clone_state(s.state), s.topology, s.current_params(), s.config,
               s._builder.num_nodes)

    print("phase 12b: T25 and T26 against their twins on the window's last state")
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    failed = st.sim_failed
    c = clone_state(st)
    x, msn, diag, wf, active = pd.substep_head_plain(c, topo, params, cfg, True)
    colls = pd.detect_point_tri(c, x, topo, params, cfg, active, plain=False)
    lay = broadphase.tri_layout(cfg, topo.triangles.shape[0], "celllist")
    sc = broadphase.scalars(params)
    ov = torch.zeros(1, dtype=torch.int32, device=dev)
    cand, count, flags = broadphase.tri_candidates(x, c.prev_positions, topo.triangles,
                                                   topo.tri_mask, lay, sc, ov, failed)
    cap = cfg.budget.max_edge_contacts
    args25 = (x, c.prev_positions, topo.triangles, cand, count, flags, cap, False, failed)
    k25 = broadphase.edge_ccd(*args25)
    p25 = broadphase.edge_ccd_plain(*args25)
    torch.cuda.synchronize()
    n_e, hits = int(p25[2][0]), int(p25[3][0])
    check(all(torch.equal(a, b) for a, b in zip(k25, p25)) and n_e > 0,
          f"T25 contacts, their order, the count ({n_e}) and the hits before the cap ({hits})"
          f" equal the twin's")
    t_rows, nb = cand.shape
    slot = torch.arange(nb, device=dev)[None, :]
    live_pairs = int(((slot < count[:, None]) & (cand > torch.arange(t_rows, device=dev)[:, None]))
                     .sum())
    n_nodes = st.capacity
    row("edge_ccd", "pies_tpu_torch/kernels/csrc/edge_ccd.cu",
        "pies_tpu/collision/broadphase.py:1450", 0.0,
        cuda_ms(lambda: broadphase.edge_ccd(*args25), 20),
        cuda_ms(lambda: broadphase.edge_ccd_plain(*args25), 2), "equal",
        4 * t_rows * nb + 16 * t_rows + 24 * n_nodes + 20 * n_e, 9 * 220 * live_pairs)
    colls.edge_idx, colls.edge_mask, colls.edge_count, colls.edge_hits = k25
    _, h2 = pd._h_h2(params)
    inc = ptd = None
    if colls.pt_idx is not None:
        inc, ptd = tetcols.pt_coupling_setup_plain(colls, st.mass, topo, h2, diag, wf)
    out = []
    for setup in (assembly.edge_setup, assembly.edge_setup_plain):
        dg = diag.clone()
        e = setup(colls, st.mass, st.inv_mass, topo, h2, dg, wf, params.collision_thickness,
                  cfg.reference_quirks, True, failed, None, inc, ptd, None, colls.pt_count)
        out.append((e, dg))
    (ek, dk), (ep, dp) = out
    torch.cuda.synchronize()
    on = incident(ep.inc)
    n_ent = int(ep.inc.row_start[-1])
    ulp26 = max(max_ulp(dk, dp), max_ulp(ek.ed[on], ep.ed[on]))
    check(torch.equal(ek.inc.row_start, ep.inc.row_start)
          and torch.equal(ek.inc.entries[:n_ent], ep.inc.entries[:n_ent]) and ulp26 <= 1.0,
          f"T26 setup: incidence equal ({n_ent} entries, {int(on.sum())} nodes), diagonals"
          f" within 1 ulp ({ulp26} ulp)")
    rows_k = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats.clone(), topo,
                                 cfg.rotation_iterations, failed)
    plane = pd.floor_plane(params, cfg.reference_quirks)
    fk = assembly.assemble_force(x, msn, wf, rows_k, topo, plane, failed, edges=ek)
    fp = assembly.assemble_force_plain(x, msn, wf, rows_k, topo, plane, edges=ep)
    yk, _ = assembly.apply_system(x, st.mass, wf, h2, topo, failed, edges=ek)
    yp, _ = assembly.apply_system_plain(x, st.mass, wf, h2, topo, edges=ep)
    edges_only = dataclasses.replace(colls, pt_idx=None)
    a, b = clone_state(c), clone_state(c)
    xa, xb = x.clone(), x.clone()
    pd.pt_tail(a, params, cfg, edges_only, None, xa, fk[1], ek, None, pd.STABILIZE)
    pd.pt_tail_plain(b, params, cfg, edges_only, None, xb, fk[1], ep, None, pd.STABILIZE)
    torch.cuda.synchronize()
    ulps = {"T9": max_ulp(fk[0], fp[0]), "T10": max_ulp(yk, yp),
            "T8": max(max_ulp(xa, xb), max_ulp(a.prev_positions, b.prev_positions))}
    check(max(ulps.values()) <= 1.0, f"T26's terms in T9's stage 2, T10 and T8 within 1 ulp of"
          f" the twins ({ulps}); T8's pass moves x by {float((xa - x).abs().max()):.3e}")
    err26 = max(float((fk[0] - fp[0]).abs().max()), float((yk - yp).abs().max()),
                float((xa - xb).abs().max()))
    ent_nodes = ep.inc.nodes[:n_ent].long()
    ent_1 = torch.ones((n_ent, 1), device=dev)
    ent_3 = torch.ones((n_ent, 3), device=dev)
    carried = {
        "T9": (cuda_ms(lambda: assembly.assemble_force(x, msn, wf, rows_k, topo, plane, failed,
                                                       edges=ek), 20),
               cuda_ms(lambda: assembly.assemble_force(x, msn, wf, rows_k, topo, plane,
                                                       failed), 20)),
        "T10": (cuda_ms(lambda: assembly.apply_system(x, st.mass, wf, h2, topo, failed,
                                                      edges=ek), 20),
                cuda_ms(lambda: assembly.apply_system(x, st.mass, wf, h2, topo, failed), 20)),
        "T8": (cuda_ms(lambda: pd.pt_tail(clone_state(c), params, cfg, edges_only, None,
                                          x.clone(), fk[1], ek, None, pd.STABILIZE), 10), 0.0)}
    lib_rows = cuda_ms(lambda: torch.zeros((n_nodes, 3), device=dev).index_add_(0, ent_nodes,
                                                                                ent_3), 20)
    print("  T26's terms, kernel ms with and without them: "
          + ", ".join(f"{k} {w:.4f} / {wo:.4f}" for k, (w, wo) in carried.items())
          + f"; index_add_ of the {n_ent} entry rows {lib_rows:.4f} ms ({smi})")
    edge_bytes = 20 * cap + 8 * 4 * cap + 24 * int(on.sum())
    row("edge_terms", "pies_tpu_torch/kernels/csrc/edge_terms.cu",
        "pies_tpu/solver/assembly.py:371", err26,
        cuda_ms(lambda: assembly.edge_setup(colls, st.mass, st.inv_mass, topo, h2, diag.clone(),
                                            wf, params.collision_thickness, False, True,
                                            failed, None, inc, ptd, None, colls.pt_count), 20),
        cuda_ms(lambda: assembly.edge_setup_plain(colls, st.mass, st.inv_mass, topo, h2,
                                                  diag.clone(), wf, params.collision_thickness,
                                                  False, True, failed, None, inc, ptd, None,
                                                  colls.pt_count), 2),
        f"{max(ulps.values())} ulp", edge_bytes, 8 * n_ent,
        cuda_ms(lambda: torch.zeros((n_nodes, 1), device=dev).index_add_(0, ent_nodes, ent_1),
                20))
    del s, st, c, colls, cand, k25, p25, ek, ep, rows_k, fk, fp, yk, yp, a, b, xa, xb

    # 12c: a PD node cloud.
    t0 = time.perf_counter()
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=False,
                  enable_node_collisions=True,
                  budget_overrides=dict(max_node_node_contacts=32 * cloud_n // 2), device=dev)
    add_node_pile(s, cloud_n)
    s._prepare()
    print(f"phase 12c: a PD node cloud, {cloud_n} nodes (add_node_pile, seed 3), node-node"
          f" contacts on, cap {s.config.budget.max_node_node_contacts}"
          f" (set-up {time.perf_counter() - t0:.2f} s)")
    warm = clone_state(s.state)
    cloud_path = ["substep_head", "node_pairs", "node_contacts", "tet_force_nodes",
                  "ell_matvec", "pcg", "substep_tail"]
    contact_window("12c", s, cloud_path, 1, ("node_pairs", "touching_pairs"))
    kernels_vs_twins(s, warm)

    print("phase 12c: T27 against its twin on the cloud after 10 ticks")
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    failed, n_nodes = st.sim_failed, st.capacity
    x, msn, diag, wf, active = pd.substep_head_plain(clone_state(st), topo, params, cfg, True)
    nn = broadphase.detect_node_node_pairs(x, st.radius, st.node_mask, params, cfg, failed)
    cap = cfg.budget.max_node_node_contacts
    _, h2 = pd._h_h2(params)

    def setup27(fn):
        dg, sd = diag.clone(), wf.clone()
        return fn(nn, cap, st.mass, st.radius, st.inv_mass, topo, h2, dg, wf, failed, sd), dg, sd

    (tk, dk, sk), (tp, dp, sp) = setup27(assembly.node_setup), setup27(assembly.node_setup_plain)
    ik, ck = pd.node_friction(x, st, params, tk, failed)
    ip, cp = pd.node_friction_plain(x, st, params, tp, failed)
    rows_k = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats.clone(), topo,
                                 cfg.rotation_iterations, failed)
    plane = pd.floor_plane(params, cfg.reference_quirks)
    fk = assembly.assemble_force(x, msn, sp, rows_k, topo, plane, failed, nodes=tk)
    fp = assembly.assemble_force_plain(x, msn, sp, rows_k, topo, plane, nodes=tp)
    ta, tb = clone_state(st), clone_state(st)
    pd.substep_tail(ta, topo, params, active, x, fk[1], nn_imp=ik)
    pd.substep_tail_plain(tb, topo, params, active, x, fk[1], nn_imp=ip)
    torch.cuda.synchronize()
    lim = int(tp.lim[0])
    ulps = {"setup": max(max_ulp(dk, dp), max_ulp(sk, sp)), "friction": max_ulp(ik, ip),
            "T9": max_ulp(fk[0], fp[0]), "T4": max_ulp(ta.velocities, tb.velocities)}
    check(int(tk.lim[0]) == lim > 0 and int(ck[0]) == int(cp[0]) > 0
          and max(ulps.values()) <= 1.0,
          f"T27 ({lim} live pairs, {int(cp[0])} touching): setup, friction, its force in T9's"
          f" stage 2 and T4 with its impulse within 1 ulp of the twins ({ulps})")
    err27 = max(float((ik - ip).abs().max()), float((fk[0] - fp[0]).abs().max()))
    pair_nodes = torch.cat([nn.pi[:lim], nn.pj[:lim]]).long()
    pair_rows = torch.ones((2 * lim, 4), device=dev)

    def both(setup, fric):
        t, _, _ = setup27(setup)
        fric(x, st, params, t, failed)

    t9 = (cuda_ms(lambda: assembly.assemble_force(x, msn, sp, rows_k, topo, plane, failed,
                                                  nodes=tk), 20),
          cuda_ms(lambda: assembly.assemble_force(x, msn, sp, rows_k, topo, plane, failed), 20))
    print(f"  T27's force in T9's stage 2, kernel ms with and without it: {t9[0]:.4f} /"
          f" {t9[1]:.4f} ({smi})")
    row("node_contacts", "pies_tpu_torch/kernels/csrc/node_contacts.cu",
        "pies_tpu/collision/broadphase.py:1975", err27,
        cuda_ms(lambda: both(assembly.node_setup, pd.node_friction), 20),
        cuda_ms(lambda: both(assembly.node_setup_plain, pd.node_friction_plain), 2),
        f"{max(ulps.values())} ulp", 68 * n_nodes + 40 * lim, 80 * lim,
        cuda_ms(lambda: torch.zeros((n_nodes, 4), device=dev).index_add_(0, pair_nodes,
                                                                         pair_rows), 20))
    return nets12b


def device_idle(solver, ticks=10):
    """A traced window of ``ticks`` ticks of ``solver``: ``(wall ms, device
    busy ms)`` from ``torch.profiler``'s CUDA events (tick_profile's
    reading)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pies_tpu_torch.tick_profile import device_events

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.run_ticks(ticks)
        wall = time.perf_counter() - t0
    return wall * 1e3, sum(us for _, us in device_events(prof)) / 1e3


def device_us(fn, reps=5):
    """Device time of one call of ``fn`` in µs: the profiler's CUDA events
    over ``reps`` calls, summed, over ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pies_tpu_torch.tick_profile import device_events

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(us for _, us in device_events(prof)) / reps


def device_kernels(fn, reps=5, rounds=3):
    """The device work of one call of ``fn`` from ``rounds`` profiles of
    ``reps`` calls each (the profiler's CUDA events, divided by ``reps``):
    ``({name: (count, µs)}, [{name: count} of each round])`` per kernel,
    memcpy and memset name.  The profiler now and then loses records (in
    ~1% of profiles of the main path's calls some or all of a kernel's
    records of the 5 calls: ``scripts/contact_kernels_profile.py
    --record-rounds``), and a lost record only lowers a count, so each
    name's count is the largest of the rounds, with that round's µs; every
    round is returned for the log."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pies_tpu_torch.tick_profile import device_events

    fn()
    torch.cuda.synchronize()
    every, best = [], {}
    for _ in range(rounds):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = {e.key: (e.count / reps, us / reps) for e, us in device_events(prof)}
        every.append({key: count for key, (count, _) in got.items()})
        for key, (count, us) in got.items():
            if key not in best or count > best[key][0]:
                best[key] = (count, us)
    return best, every


def device_kinds(events):
    """``(kernels, memcpys, memsets, µs)`` of :func:`device_kernels`'
    result."""
    n = {"Memcpy": 0.0, "Memset": 0.0, "kernel": 0.0}
    for name, (count, _) in events.items():
        n[name.split()[0] if name.startswith(("Memcpy", "Memset")) else "kernel"] += count
    return n["kernel"], n["Memcpy"], n["Memset"], sum(us for _, us in events.values())


def phase14(pt, dev, smi, PD, row, launches, reset_launches, read_launches, keep, mesh_res,
            mesh_scale, mesh_dump):
    """The tet mesher, ``Solver.add_tri_mesh_volume`` and the diagnostics:
    14a the cube meshed at full width and stepped, 14b ``tet_cube_drop``,
    14c T28 and 14d T29 against their twins."""
    import numpy as np
    import torch

    from pies_tpu_torch import diagnostics
    from pies_tpu_torch.collision import broadphase
    from pies_tpu_torch.scene import tetmesh
    from pies_tpu_torch.scene.mesh_dump import load_mesh_txt
    from pies_tpu_torch.solver import pd

    cube_v, cube_f = np.float32(CUBE_VERTS), np.int32(CUBE_TRIS)

    def path_of(s):
        """The kernels of a PD tick with self-contact on ``s``'s scene: the
        generic path and the detection branch its dispatch picks."""
        cfg, n_tris = s.config, s.topology.tri_mask.shape[0]
        det = (["tri_candidates", "tri_ccd"] if broadphase.tri_mode(cfg, n_tris)
               else ["super_broadphase", "super_narrowphase"] if broadphase.super_body(cfg)
               else ["body_broadphase", "pt_narrowphase"])
        return ["substep_head"] + det + ["pt_coupling", "tet_force_nodes", "ell_matvec", "pcg",
                                         "pt_tail", "substep_tail"]

    def to_floor(s, label, start):
        """``start`` ticks, then tick by tick to the first tick with
        floor-active nodes; returns that tick."""
        s.run_ticks(start)
        for tick in range(start + 1, start + 200):
            c = pd.new_counters(dev)
            s.counters = c
            s.run_ticks(1)
            s.counters = None
            if int(c["floor_active"]) > 0:
                check(not s.sim_failed, f"{label}: floor contact at tick {tick}, no sim_failed")
                return tick
        raise SystemExit(f"FAILED: {label}: no floor contact by tick {start + 200}")

    def timed(label, s, first):
        """``run_ticks(10)`` with the launch counts reset before, then the
        diagnostics of the state reached (``solver_stats``,
        ``broadphase_health``) inside the same count; gates and prints the
        window (launches per tick without the diagnostics), and a traced
        window's device idle share."""
        names = path_of(s)
        reset_launches()
        c = pd.new_counters(dev)
        s.counters = c
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run_ticks(10)
        sec = (time.perf_counter() - t0) / 10
        s.counters = None
        ticks = read_launches()
        stats = diagnostics.solver_stats(s)
        health = diagnostics.broadphase_health(s)
        launches[label] = read_launches()
        counts = {k: int(v) for k, v in c.items()}
        pos = s.state.positions[: s._builder.num_nodes]
        check(not s.sim_failed and bool(torch.isfinite(pos).all()),
              f"{label}: no sim_failed, all positions finite")
        check(counts["floor_active"] > 0,
              f"{label}: floor contact in the window: {counts['floor_active']} node-substeps")
        check(all(launches[label][n] > 0 for n in names + ["residuals", "occupancy"]),
              f"{label}: every kernel of the path launched, T28 and T29 by the diagnostics:"
              f" {launches[label]}")
        check(set(stats) >= set(diagnostics.KEYS) and stats["ticks"] == s.ticks
              and all(np.isfinite(stats[k]) for k in diagnostics.KEYS),
              f"{label}: solver_stats {stats}")
        check(health["candidate_budget"] > 0 and health["pt_contact_cap"] > 0,
              f"{label}: broadphase_health {health}")
        per_tick = {n: ticks[n] / 10 for n in names}
        wall, busy = device_idle(s)
        print(f"  {label}: {sec * 1e3:.3f} ms/tick, {1.0 / sec:.2f} steps/s ({smi}; ticks"
              f" {first + 1}-{first + 10}; counters {counts}; launches per tick {per_tick};"
              f" traced ticks {first + 11}-{first + 20}: wall {wall:.3f} ms, device busy"
              f" {busy:.3f} ms, idle {100 - 100 * busy / wall:.1f}%)")

    # 14a: the cube meshed at full width through add_tri_mesh_volume.
    print(f"phase 14a: add_tri_mesh_volume(cube x {mesh_scale:g}, resolution={mesh_res})")
    t0 = time.perf_counter()
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, device=dev)
    ids = s.add_tri_mesh_volume(cube_v * np.float32(mesh_scale), cube_f, resolution=mesh_res)
    t_mesh = time.perf_counter() - t0
    check(tetmesh.last_route == "native", f"the native mesher ran ({tetmesh.last_route}),"
          f" {t_mesh:.2f} s with its g++ build")
    b = s._builder
    points, tets, surface = b.all_positions(), b.tets[0], s.get_triangles()
    ref = load_mesh_txt(mesh_dump)
    dp = float(np.abs(points - ref[0]).max())
    check(np.array_equal(tets, ref[1]) and np.array_equal(surface, ref[2])
          and dp <= 1e-6 * mesh_scale,
          f"{len(ids)} nodes, {len(tets)} tets, {len(surface)} surface triangles: tets and"
          f" surface equal to {os.path.basename(mesh_dump)}, points within {dp:.3e}")
    t0 = time.perf_counter()
    st, topo = s.state, s.topology
    check(float(st.radius[0]) == 0.5 and float(st.inv_mass[0]) == 1.0
          and topo.strain.idx.shape[0] >= len(tets) and topo.volume.idx.shape[0] >= len(tets),
          f"set-up {time.perf_counter() - t0:.2f} s: radius 0.5, inverse mass 1, strain and"
          f" volume rows for every tet; detection kernels {path_of(s)[1:3]}")
    first = to_floor(s, "14a", 60)
    timed("14a", s, first)
    mesh = s
    del s, st, topo, ref, points

    # 14b: tet_cube_drop as scripts/bench_all.py:80-102 builds it.
    print(f"phase 14b: tet_cube_drop (the cube meshed at {DROP_RES}, radius 0.2, w 1000)")
    pts, tts, srf = tetmesh.tetrahedralize(cube_v, cube_f, DROP_RES)
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, device=dev)
    ids = s._builder._emit_nodes(pts, inv_mass=1.0, radius=0.2)
    s._builder._emit_tets(ids[tts], 1000.0)
    s._builder._emit_triangles(ids[srf])
    s._dirty = True
    check(tetmesh.last_route == "native" and len(ids) == 1331 and len(tts) == 6000,
          f"{len(ids)} nodes, {len(tts)} tets, {len(srf)} surface triangles (native route)")
    first = to_floor(s, "14b", 10)
    timed("14b", s, first)
    drop = s
    del s

    # 14c: T28 against its twin.
    print("phase 14c: T28 (constraint_residuals) against its twin")
    from pies_tpu_torch.scene.mesh_dump import add_tet_mesh

    pinned = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=False, device=dev)
    add_tet_mesh(pinned, *load_mesh_txt(MESH_SMALL), pins=SMALL_PINS)
    pinned.run_ticks(40)
    held = {}
    for label, solver, keys in (("14a's mesh", mesh, ("strain", "volume", "max_speed")),
                                ("phase 6's cloth", keep["cloth"], ("distance", "bend")),
                                ("the pinned 1,331-node mesh", pinned, ("position",))):
        st, topo = solver.state, solver.topology
        k = diagnostics.constraint_residuals(st, topo)
        p = diagnostics.constraint_residuals_plain(st, topo)
        errs = {key: abs(float(k[key]) - float(p[key])) / max(abs(float(p[key])), 1e-30)
                for key in diagnostics.KEYS}
        check(all(errs[key] <= 1e-6 for key in diagnostics.KEYS)
              and all(float(p[key]) != 0.0 for key in keys),
              f"{label}: every key within 1e-6 relative of the twin (largest"
              f" {max(errs.values()):.3e}; bit-equal: {[key for key in errs if errs[key] == 0]});"
              f" {', '.join(f'{key} {float(k[key]):.6g}' for key in keys)}")
        held[label] = max(errs.values())
    st, topo = mesh.state, mesh.topology
    n_nodes, n_tets = st.capacity, topo.strain.idx.shape[0]
    fn = lambda: diagnostics.constraint_residuals(st, topo)  # noqa: E731
    # Bytes: positions, velocities and the node mask once; per strain and per
    # volume row its ids, Q^-1, lo, hi and w (64 bytes); the 7 results.
    # Operations: a strain row ~1,800 (F and F^T F as 90 fused steps, 24
    # Jacobi rotations of ~70, the violations), a volume row ~65, a node 12.
    nbytes = 28 * n_nodes + 64 * 2 * n_tets + 28
    ops = 1800 * n_tets + 65 * n_tets + 12 * n_nodes
    row("residuals", "pies_tpu_torch/kernels/csrc/residuals.cu", "pies_tpu/diagnostics.py:33",
        held["14a's mesh"], cuda_ms(fn, 20),
        cuda_ms(lambda: diagnostics.constraint_residuals_plain(st, topo), 3),
        "1e-6 relative", nbytes, ops)
    print(f"  T28 on 14a's mesh ({n_tets} strain and volume rows, {n_nodes} nodes): device"
          f" {device_us(fn):.2f} us per call ({smi})")

    # 14d: T29 against its twin in each branch, and broadphase_health.
    print("phase 14d: T29 (candidate occupancy, oversize counts) against its twin")
    timing = None
    for label, solver in (("phase 3b's soup", keep["soup"]),
                          ("phase 9a's box pile", keep["box_pile"]), ("14a's mesh", mesh),
                          ("14b's tet_cube_drop", drop)):
        st, topo, cfg = solver.state, solver.topology, solver.config
        lay = broadphase.occupancy_layout(cfg, topo.triangles.shape[0])
        sc = broadphase.scalars(solver.current_params())
        args = (st.positions, st.prev_positions, topo.triangles, topo.tri_mask, lay, sc)
        k, p = broadphase.occupancy(*args), broadphase.occupancy_plain(*args)
        words = dict(zip(broadphase.OCC_WORDS, p.tolist()))
        check(torch.equal(k, p) and words["count_max"] > 0,
              f"{label}: {lay.mode} branch, {lay.t} triangle rows ({lay.k} rows): words equal"
              f" {words}")
        health = diagnostics.broadphase_health(solver)
        cmax, cmean, cap = broadphase.occupancy_result(p.tolist(), cfg, lay.t)
        check(health["candidate_count_max"] == cmax and health["candidate_count_mean"] == cmean
              and health["candidate_budget"] == cap
              and health["broadphase_oversize_items"] == words["oversize"]
              and health["broadphase_latching_items"] == words["latching"],
              f"{label}: broadphase_health equals the twin's words: {health}")
        if label == "14a's mesh":
            timing = args
    n_tris = timing[2].shape[0]
    fn = lambda: broadphase.occupancy(*timing)  # noqa: E731
    # Bytes: the positions and previous positions of the nodes that live
    # triangles reach (the kernel reads no other node), the triangles and
    # their mask, the table (read and written once), the 5 words.
    # Operations: per row ~60 (its swept box from 18 divided coordinates,
    # the extents).
    lay = timing[4]
    n_reached = torch.unique(timing[2][timing[3] > 0]).numel()
    row("occupancy", "pies_tpu_torch/kernels/csrc/occupancy.cu",
        "pies_tpu/collision/broadphase.py:1183", 0.0, cuda_ms(fn, 20),
        cuda_ms(lambda: broadphase.occupancy_plain(*timing), 3), "equal",
        24 * n_reached + 16 * n_tris + 8 * lay.h + 20, 60 * n_tris)
    print(f"  T29 on 14a's mesh ({n_tris} rows, cell list, {n_reached} nodes reached): device"
          f" {device_us(fn):.2f} us per call ({smi})")
    keep.clear()


def phase15(pt, dev, smi, PD, rows, launches, reset_launches, read_launches, generic,
            members=ENS_DROP, rope_members=ENS_ROPE, drop_res=DROP_RES, cloth=ENS_CLOTH,
            block=ENS_BLOCK):
    """Phase 15: ensembles on the contact-free generic PD path (ROADMAP item
    10b-i): 15a the reference's own ensemble rollout, 15b ``members`` x
    ``tet_cube_drop`` timed, 15c the batched kernels against their twins
    and against B launches at B = 1, 15d a pre-latched member."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pies_tpu_torch.constraints import projections as proj
    from pies_tpu_torch.parallel import ensemble
    from pies_tpu_torch.scene.cube_drop import add_cube_drop, lifted_ensemble
    from pies_tpu_torch.scene.rigged_cloth import add_rigged_cloth
    from pies_tpu_torch.solver import assembly, pd, step, tetcols
    from pies_tpu_torch.state import member, stack_ensemble, unstack
    from pies_tpu_torch.tick_profile import device_events
    from pies_tpu_torch.topology import row_layout

    fields = ("positions", "prev_positions", "velocities", "forces", "sim_failed", "shape_quats")

    def same(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)

    t_phase = time.perf_counter()

    def lap(what):
        print(f"  ({what}: {time.perf_counter() - t_phase:.1f} s into phase 15)")

    # 15a: tests/test_diagnostics.py:47-76 at its size, StepConfig defaults.
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=False, device=dev)
    s.create_rope((0.0, 6.0, 0.0), (3.5, 6.0, 0.0), 8, 2000.0)
    s._prepare()
    topo, params = s.topology, pt.make_params(pt.SolverOptions())
    cfg = pt.StepConfig(solver=PD, enable_collisions=False)
    states, single = stack_ensemble(s.state, rope_members), clone_state(s.state)
    print(f"phase 15a: the reference's ensemble rollout, {rope_members} x an 8-node rope (one"
          f" pin, w 2000, StepConfig defaults: cg_rtol {cfg.cg_rtol}), 10 ticks of"
          " ensemble_step")
    for _ in range(10):
        max_res, n_failed = ensemble.ensemble_step(states, topo, params, cfg)
        step.tick(single, topo, params, cfg)
    torch.cuda.synchronize()
    check(int(n_failed) == 0 and math.isfinite(float(max_res))
          and bool(torch.isfinite(states.positions).all()),
          f"num_failed 0, max_residual {float(max_res):.4g} finite, positions finite")
    check(torch.equal(states.positions[0], states.positions[-1])
          and all(same(member(states, b), single) for b in range(rope_members)),
          f"member 0 equals member {rope_members - 1}; all {rope_members} members bit-equal to"
          " the single-scene run")
    del s, states, single

    # 15b: members x tet_cube_drop, self-contact off, each member lifted.
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=False, device=dev)
    ids = add_cube_drop(s, drop_res)
    s._prepare()
    topo, params, cfg = s.topology, s.current_params(), s.config
    live = len(ids)
    states = lifted_ensemble(s.state, members, live)
    n_tets = int((topo.strain.w > 0).sum())
    print(f"phase 15b: {members} x tet_cube_drop (meshed at {drop_res}: {live} nodes,"
          f" {n_tets} tets each; {members * live} nodes, {members * n_tets} tets a tick),"
          f" self-contact off, {cfg.iterations} iterations, {cfg.cg_iterations} CG trips,"
          f" cg_rtol {cfg.cg_rtol}")
    check(not tetcols.applies(states, topo, cfg) and topo.ell_nbr is not None,
          f"the contact-free generic path, ELL width {topo.ell_nbr.shape[0]}")
    seen = torch.zeros(members, dtype=torch.bool, device=dev)
    for tick in range(1, 121):
        c = pd.new_counters(dev, members)
        ensemble.ensemble_tick(states, topo, params, cfg, counters=c)
        seen |= c["floor_active"] > 0
        if bool(seen.all()):
            break
    else:
        raise SystemExit(f"FAILED: 15b: {int((~seen).sum())} members never on the floor")
    check(not bool(states.sim_failed.any()), f"every member has had floor-active nodes by tick"
          f" {tick} (member 0's floor tick is ~27), none latched")
    lap("15b warm-up")
    sampled = [b for b in ENS_SAMPLED if b < members]
    starts = {b: unstack(states, b) for b in sampled}
    windows, on_floor = [], torch.zeros(members, dtype=torch.int64, device=dev)
    for w in range(3):
        first = tick + 10 * w + 1
        reset_launches()
        c = pd.new_counters(dev, members)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ensemble.ensemble_tick_n(states, topo, params, cfg, 10, counters=c)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / 10
        launches["15b"] = read_launches()
        counts = {k: v.tolist() for k, v in c.items()}
        per_tick = sum(launches["15b"][n] for n in generic) / 10
        trips = counts["cg_trips"]
        solves = 10 * cfg.time_substeps * cfg.iterations
        windows.append(sec)
        on_floor += c["floor_active"]
        print(f"  window {w + 1}: {sec * 1e3:.3f} ms/tick, {members / sec:.1f} scene-steps/s"
              f" ({smi}; ticks {first}-{first + 9}; max residual {float(res):.4g});"
              f" {per_tick:.1f} launches per tick; CG trips per solve {min(trips) / solves:.2f}"
              f" to {max(trips) / solves:.2f} over the members ({len(set(trips))} distinct"
              f" counts); floor-active node-substeps {min(counts['floor_active'])} to"
              f" {max(counts['floor_active'])} per member, in"
              f" {sum(v > 0 for v in counts['floor_active'])} of {members} members")
        check(sum(counts["floor_active"]) > 0 and not bool(states.sim_failed.any())
              and bool(torch.isfinite(states.positions[:, :live]).all()),
              "floor-active nodes in the window, no member latched, positions finite")
    # The cubes land from tick ~27 to ~40 and hop off the floor ~20 ticks
    # after landing, so a member may be airborne through one 10-tick call:
    # every member is gated on floor contact in the 30 timed ticks.
    check(int(on_floor.min()) > 0, f"floor-active nodes in every member over ticks {tick + 1}-"
          f"{tick + 30}: {int(on_floor.min())} to {int(on_floor.max())} node-substeps a member")
    for b, sb in starts.items():
        step.tick_n(sb, topo, params, cfg, 30)
    check(all(same(member(states, b), sb) for b, sb in starts.items()),
          f"members {sampled} bit-equal to their single-scene kernel runs over the 30 ticks")
    # The exit window: at the Solver's 16 trips no solve of this mesh meets
    # cg_rtol 1e-4 (every member runs 4 x 16 trips a tick), so the
    # per-member exit is shown with the trip cap raised to 64, the same
    # rtol: each member's solves leave at their own trips.
    exit_cfg = dataclasses.replace(cfg, cg_iterations=64)
    starts = {b: unstack(states, b) for b in sampled}
    c = pd.new_counters(dev, members)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ensemble.ensemble_tick_n(states, topo, params, exit_cfg, 10, counters=c)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / 10
    trips = c["cg_trips"].tolist()
    solves = 10 * cfg.time_substeps * cfg.iterations
    print(f"  exit window (cg_iterations 64, cg_rtol {cfg.cg_rtol}; ticks {tick + 31}-{tick + 40}):"
          f" {sec * 1e3:.3f} ms/tick ({smi}); CG trips per solve {min(trips) / solves:.2f} to"
          f" {max(trips) / solves:.2f} over the members, {len(set(trips))} distinct counts")
    check(len(set(trips)) > 1 and max(trips) < 64 * solves and not bool(states.sim_failed.any()),
          "per-member CG trip counts not all equal and below the cap: each member's own exit")
    singles_trips = {}
    for b, sb in starts.items():
        cb = pd.new_counters(dev)
        step.tick_n(sb, topo, params, exit_cfg, 10, counters=cb)
        singles_trips[b] = int(cb["cg_trips"])
    check(all(same(member(states, b), sb) and singles_trips[b] == trips[b]
              for b, sb in starts.items()),
          f"members {sampled} bit-equal to their single-scene runs over the exit window, trips"
          f" equal ({[singles_trips[b] for b in sampled]})")
    one = stack_ensemble(unstack(states, 0), 1)
    reset_launches()
    ensemble.ensemble_tick_n(one, topo, params, cfg, 10)
    torch.cuda.synchronize()
    launches["15b B=1"] = read_launches()
    check(launches["15b B=1"] == launches["15b"] and all(launches["15b"][n] > 0 for n in generic),
          f"launches per tick at B = {members} equal those at B = 1: {per_tick:.1f}"
          f" ({ {n: launches['15b'][n] / 10 for n in generic} })")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ensemble.ensemble_tick_n(states, topo, params, cfg, 10)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy = sum(us for _, us in events) / 1e3
    print(f"  traced ticks {tick + 41}-{tick + 50}: wall {wall:.3f} ms, device busy {busy:.3f} ms,"
          f" idle {100 - 100 * busy / wall:.1f}% ({smi}); device time per tick by kernel:")
    for e, us in sorted(events, key=lambda eu: -eu[1])[:8]:
        print(f"    {us / 10:9.2f} us/tick  x{e.count / 10:<6.1f} {e.key[:80]}")
    print(f"  15b: {min(windows) * 1e3:.3f} to {max(windows) * 1e3:.3f} ms/tick over the three"
          f" windows, {members / max(windows):.1f} to {members / min(windows):.1f}"
          " scene-steps/s")
    drop = (s, states, live)
    del starts, one
    lap("15b")

    # 15c: the kernels against the batched twin, and each stage at B against
    # B launches at B = 1.
    def stage_checks(label, st, topo, params, cfg):
        """One substep's stages on ``st`` (a copy), each kernel against its
        batched twin on the same inputs (the kernels' outputs carried
        forward); returns the inputs of the timings."""
        b_, n = st.members, st.capacity
        work = clone_state(st)
        head = pd.substep_head(work, topo, params, cfg, False)
        hp = pd.substep_head_plain(clone_state(st), topo, params, cfg, False)
        x, msn, diag, wf, active = head
        failed = work.sim_failed
        _, h2 = pd._h_h2(params)
        plane = pd.floor_plane(params, cfg.reference_quirks)
        held = {"T3": all(torch.equal(a, b) for a, b in zip(head, hp))}
        factors = None
        if pd.block_layout(work, topo):
            factors = assembly.tet_block_factor(diag, topo.tet_block6, failed)
            held["T22"] = torch.equal(factors, assembly.tet_block_factor_plain(diag,
                                                                               topo.tet_block6))
        qk, qp = work.shape_quats.clone(), work.shape_quats.clone()
        rk = assembly.local_step(x, work.inv_mass, work.mass, qk, topo,
                                 cfg.rotation_iterations, failed)
        rp = assembly.local_step(x, work.inv_mass, work.mass, qp, topo,
                                 cfg.rotation_iterations, failed, plain=True)
        for name, (at, cnt) in row_layout(topo).items():
            if cnt:
                a, b = rk[:, at:at + cnt], rp[:, at:at + cnt]
                if name in ("bend", "shape"):  # acosf, sinf, cosf against torch's
                    held[name] = float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
                else:
                    held[name] = torch.equal(a, b)
        if qk.shape[-2] > 1:
            held["quats"] = float((qk - qp).abs().max()) <= 1e-6
        force = assembly.assemble_force(x, msn, wf, rk, topo, plane, failed)
        held["T9 stage 2"] = all(torch.equal(a, b) for a, b in zip(
            force, assembly.assemble_force_plain(x, msn, wf, rk, topo, plane)))
        held["T10"] = all(torch.equal(a, b) for a, b in zip(
            assembly.apply_system(x, work.mass, wf, h2, topo, failed, part=True),
            assembly.apply_system_plain(x, work.mass, wf, h2, topo, part=True)))
        cg = (force[0], x, diag, work.mass, wf, h2, work.node_mask, topo, cfg.cg_iterations,
              cfg.cg_rtol, failed, factors)
        sol, solp = assembly.pcg_solve(*cg), assembly.pcg_solve_plain(*cg)
        held["T11"] = all(torch.equal(a, b) for a, b in zip(sol, solp))
        tk, tp = clone_state(work), clone_state(work)
        pd.substep_tail(tk, topo, params, active, sol[0], force[1])
        pd.substep_tail_plain(tp, topo, params, active, sol[0], force[1])
        held["T4"] = same(tk, tp)
        torch.cuda.synchronize()
        trips = sol[2][:, 0].tolist()
        check(all(held.values()), f"{label}: each kernel at B = {b_} equals its batched twin on"
              f" the same inputs ({', '.join(held)}; bend and shape rows within 1e-6 of the"
              f" largest, quaternions within 1e-6); CG trips {min(trips)} to {max(trips)},"
              " equal to the twin's")
        return dict(work=work, x=x, msn=msn, diag=diag, wf=wf, active=active, rows=rk,
                    force=force, sol=sol, factors=factors, h2=h2, plane=plane, n=n, b=b_,
                    trips=trips)

    def time_stages(label, inp, topo, params, cfg, names):
        """Each stage in ``names`` timed at B = b against b launches of it at
        B = 1 on the members' views, beside its bound; recorded in the rows."""
        work, x, failed = inp["work"], inp["x"], inp["work"].sim_failed
        b_, n, h2, plane = inp["b"], inp["n"], inp["h2"], inp["plane"]
        lay = row_layout(topo)
        rows_of = lambda name: lay[name][1]  # noqa: E731
        m = topo.ell_nbr.shape[0] if topo.ell_nbr is not None else 0
        c_t = topo.strain.idx.shape[0]
        quats = work.shape_quats.clone()
        goal_out = torch.empty((b_, rows_of("goal"), 3), device=dev) if rows_of("goal") else None
        tail = clone_state(work)
        r_all = inp["rows"].shape[-2]
        trips = inp["trips"]
        g_shape, m_shape = topo.shape.num_groups, topo.shape.node_idx.shape[0]
        m_goal, g_goal = topo.goal.node_idx.shape[0], topo.goal.num_groups
        c_dist, c_bend = topo.distance.idx.shape[0], topo.bend.idx.shape[0]
        k_blk = n // 4
        table = {
            "T3 substep_head": ("substep_head", lambda st_: pd.substep_head(
                st_, topo, params, cfg, False), (work,), 76 * b_ * n, 17 * b_ * n),
            "T9 stage 1": ("tet_force_nodes", lambda x_, f_: proj.tet_force12_gathered(
                x_, topo.strain, topo.volume, f_), (x, failed),
                124 * c_t + b_ * (12 * n + 48 * c_t), b_ * 1500 * c_t),
            "T9 stage 2": ("tet_force_nodes", lambda x_, m_, w_, r_, f_: assembly.assemble_force(
                x_, m_, w_, r_, topo, plane, f_), (x, inp["msn"], inp["wf"], inp["rows"], failed),
                4 * n + 4 * r_all + b_ * (52 * n + 12 * r_all), b_ * (3 * r_all + 12 * n)),
            "T10": ("ell_matvec", lambda x_, ms_, w_, f_: assembly.apply_system(
                x_, ms_, w_, h2, topo, f_, part=True), (x, work.mass, inp["wf"], failed),
                8 * m * n + b_ * 32 * n, b_ * (6 * m + 9) * n),
            "T11": ("pcg", lambda b0, x_, d_, ms_, w_, k_, f_, bl_: assembly.pcg_solve(
                b0, x_, d_, ms_, w_, h2, k_, topo, cfg.cg_iterations, cfg.cg_rtol, f_, bl_),
                (inp["force"][0], x, inp["diag"], work.mass, inp["wf"], work.node_mask, failed,
                 inp["factors"]),
                8 * m * n + sum(88 * n + t * 128 * n + (t + 1) * 32 * n for t in trips),
                sum((t + 1) * (6 * m + 9) * n + t * 30 * n for t in trips)),
            "T12 distance": ("constraint_rows", lambda x_, f_: proj.distance_rows(
                x_, topo.distance, f_), (x, failed), 16 * c_dist + b_ * (12 * n + 24 * c_dist),
                b_ * 30 * c_dist),
            "T12 bend": ("constraint_rows", lambda x_, im_, f_: proj.bend_rows(
                x_, im_, topo.bend, f_), (x, work.inv_mass, failed),
                24 * c_bend + b_ * (16 * n + 48 * c_bend), b_ * 250 * c_bend),
            "T13 shape": ("shape_match", lambda x_, ms_, q_, f_: proj.shape_rows(
                x_, ms_, q_, topo.shape, cfg.rotation_iterations, f_),
                (x, work.mass, quats, failed), 20 * m_shape + 60 * g_shape
                + b_ * (28 * m_shape + 32 * g_shape),
                b_ * (60 * m_shape + 200 * cfg.rotation_iterations * g_shape)),
            "T13 goal": ("shape_match", lambda f_, o_: proj.goal_rows(topo.goal, f_, o_),
                         (failed, goal_out), 24 * m_goal + 64 * g_goal + b_ * 12 * m_goal,
                         b_ * 20 * m_goal),
            "T22": ("tet_block", lambda d_, f_: assembly.tet_block_factor(
                d_, topo.tet_block6, f_), (inp["diag"], failed), 24 * k_blk + b_ * 56 * k_blk,
                b_ * 40 * k_blk),
            "T4 substep_tail": ("substep_tail", lambda st_, a_, x_, sp_: pd.substep_tail(
                st_, topo, params, a_, x_, sp_),
                (tail, inp["active"], inp["sol"][0], inp["force"][1]), 120 * b_ * n,
                25 * b_ * n),
        }
        print(f"phase 15c: {label}, each stage at B = {b_} against {b_} launches at B = 1"
              f" ({smi})")
        for stage in names:
            row_name, fn, args, nbytes, ops = table[stage]
            per = [tuple(member(t, k) for t in args) for k in range(b_)]
            ms_b = cuda_ms(lambda: fn(*args), 20)
            ms_1 = cuda_ms(lambda: [fn(*p) for p in per], 5)
            b_ms, b_by = bound(nbytes, ops)
            print(f"  {stage}: B = {b_} {ms_b:.4f} ms, {b_} x B = 1 {ms_1:.4f} ms"
                  f" ({ms_1 / ms_b:.1f}x), bound {b_ms:.4f} ms ({b_by})")
            if row_name in rows:
                rows[row_name].setdefault("ensemble_generic", {})[f"{stage}, {label}"] = dict(
                    members=b_, b_ms=ms_b, b1_x_members_ms=ms_1, bound_ms=b_ms, bound_by=b_by)

    s, states, live = drop
    label = f"15b's state ({members} x tet_cube_drop)"
    e, p = clone_state(states), clone_state(states)
    c, cp = pd.new_counters(dev, members), pd.new_counters(dev, members)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ensemble.ensemble_tick(e, topo, params, cfg, counters=c)
    torch.cuda.synchronize()
    sec_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    step.tick(p, topo, params, cfg, plain=True, counters=cp)
    torch.cuda.synchronize()
    sec_p = time.perf_counter() - t0
    apart = [b for b in range(members) if not same(member(e, b), member(p, b))]
    check(not apart and all(torch.equal(c[k], cp[k]) for k in c),
          f"one tick: all {members} members' states and counters bit-equal to the batched twin's"
          f" (CG trips {min(c['cg_trips'].tolist())} to {max(c['cg_trips'].tolist())}; apart:"
          f" {apart}); kernels {sec_k * 1e3:.3f} ms, batched twin {sec_p * 1e3:.3f} ms ({smi})")
    del e, p
    inp = stage_checks(label, states, topo, params, cfg)
    time_stages(label, inp, topo, params, cfg, ["T3 substep_head", "T9 stage 1", "T9 stage 2",
                                                "T10", "T11", "T4 substep_tail"])
    del inp
    lap("15c on 15b's state")

    side, b_cloth = cloth
    c_s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=False, device=dev)
    add_rigged_cloth(c_s, side)
    c_s._prepare()
    ctopo, cparams, ccfg = c_s.topology, c_s.current_params(), c_s.config
    cst = lifted_ensemble(c_s.state, b_cloth, c_s._builder.num_nodes)
    ensemble.ensemble_tick_n(cst, ctopo, cparams, ccfg, 20)
    reset_launches()
    ensemble.ensemble_tick_n(cst, ctopo, cparams, ccfg, 2)
    torch.cuda.synchronize()
    launches["15c cloth"] = read_launches()
    label = f"the {side} x {side} rigged cloth at B = {b_cloth}"
    check(ctopo.ell_nbr is not None and ctopo.ell_nbr.shape[0] == 9
          and not bool(cst.sim_failed.any()),
          f"{label}: the generic path with every family but the tets, ELL width 9, 22 ticks,"
          " none latched")
    inp = stage_checks(label, cst, ctopo, cparams, ccfg)
    time_stages(label, inp, ctopo, cparams, ccfg, ["T12 distance", "T12 bend", "T13 shape",
                                                   "T13 goal", "T9 stage 2", "T10", "T11"])
    del inp, c_s, cst

    n_blk, b_blk = block
    b_s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=False, device=dev)
    b_s.create_tet_soup(n_blk, **SCENE)
    b_s._prepare()
    b_s._config = dataclasses.replace(b_s.config, tet_cols=False)
    btopo, bparams, bcfg = b_s.topology, b_s.current_params(), b_s.config
    bst = lifted_ensemble(b_s.state, b_blk, b_s._builder.num_nodes)
    check(not tetcols.applies(bst, btopo, bcfg) and pd.block_layout(bst, btopo)
          and btopo.tet_band is not None and btopo.ell_nbr.shape[0] == 0,
          f"{b_blk} x {n_blk}-tet soups with tet_cols=False: the block preconditioner, the band"
          " and an ELL of width 0")
    ensemble.ensemble_tick_n(bst, btopo, bparams, bcfg, FLOOR_WARMUP)
    reset_launches()
    ensemble.ensemble_tick_n(bst, btopo, bparams, bcfg, 2)
    torch.cuda.synchronize()
    launches["15c soup"] = read_launches()
    label = f"{b_blk} x {n_blk}-tet soups off the tet-column path"
    inp = stage_checks(label, bst, btopo, bparams, bcfg)
    check(set(inp["trips"]) == {1}, "one CG trip per solve: the block preconditioner is exact")
    time_stages(label, inp, btopo, bparams, bcfg, ["T22", "T10", "T11"])
    del inp, b_s, bst
    lap("15c")

    # 15d: a member latched before the start stays frozen, the others step.
    e4 = lifted_ensemble(s.state, 4, live)
    e4.sim_failed[2, 0] = 1
    start, others = unstack(e4, 2), [unstack(e4, b) for b in (0, 1, 3)]
    c = pd.new_counters(dev, 4)
    ensemble.ensemble_tick_n(e4, topo, params, cfg, 40, counters=c)
    latched = (e4.sim_failed != 0).any(dim=-1).tolist()
    trips = c["cg_trips"].tolist()
    print(f"phase 15d: 4 x tet_cube_drop, member 2 latched before the start, 40 ticks: latched"
          f" {latched}, CG trips {trips}, floor-active node-substeps"
          f" {c['floor_active'].tolist()}")
    check(same(member(e4, 2), start) and trips[2] == 0 and int(c["floor_active"][2]) == 0,
          "the latched member is bit-unchanged and counts nothing")
    check(latched == [False, False, True, False] and min(trips[:2] + trips[3:]) > 0
          and all(not torch.equal(member(e4, b).positions, o.positions)
                  for b, o in zip((0, 1, 3), others))
          and bool(torch.isfinite(e4.positions).all()),
          "the others step, unlatched and finite")
    lap("15d")


ENS_FIELDS = ("positions", "prev_positions", "velocities", "forces", "sim_failed")


def same_state(a, b):
    """Two states (or members) bit-equal: the stepped fields, the
    broadphase cache and the node-pair cache."""
    import torch

    ok = all(torch.equal(getattr(a, f), getattr(b, f)) for f in ENS_FIELDS)
    ok = ok and (a.bp is None or all(torch.equal(getattr(a.bp, f), getattr(b.bp, f))
                                     for f in ("pairs", "valid", "ref", "fresh")))
    return ok and (a.nn is None) == (b.nn is None) and (a.nn is None or all(
        torch.equal(getattr(a.nn, f.name), getattr(b.nn, f.name))
        for f in dataclasses.fields(a.nn)))


def first_members(states, n):
    """A copy of an ensemble's first ``n`` members."""
    from pies_tpu_torch.state import member

    return clone_state(member(states, slice(0, n)))


class EnsembleChecks:
    """The checks and timings phases 16, 17 and 18 run on an ensemble:
    timed windows with the sampled members against their single-scene runs
    (:meth:`windows`), one tick against the batched twin
    (:meth:`batched_twin`), each stage of ``solver/stages.contact_stages``
    against its twins (:meth:`stage_checks`) and timed at B against B
    launches at B = 1 (:meth:`time_stages`)."""

    def __init__(self, dev, smi, rows, launches, reset_launches, read_launches, phase,
                 sampled="d"):
        self.dev, self.smi, self.rows, self.launches = dev, smi, rows, launches
        self.reset, self.read, self.phase = reset_launches, read_launches, phase
        self.sampled = phase + sampled  # the label of the members' checks

    def counters(self, cfg, members=0):
        """Zeroed device counters of the configuration's solver (PD or
        PBD), i64[members] for an ensemble."""
        from pies_tpu_torch.options import SolverName
        from pies_tpu_torch.solver import pbd, pd

        return (pbd if cfg.solver == SolverName.PBD else pd).new_counters(self.dev, members)

    def windows(self, label, states, env, first_tick, detection, every=("floor_active",),
                show=("contacts", "rebuilds", "cg_trips", "floor_active")):
        """Three timed ``ensemble_tick_n(10)`` windows from ``first_tick``
        with the device counters on, gated on no latch, finite positions,
        the counters ``every`` above 0 in every member over the 30 ticks and
        the ``detection`` kernels launched; then the sampled members
        against their single-scene runs (``sampled``'s checks), the launches at
        B = 1 and the third window again, traced.  Returns the counters
        summed over the 30 ticks."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from pies_tpu_torch.parallel import ensemble
        from pies_tpu_torch.solver import step
        from pies_tpu_torch.state import member, stack_ensemble, unstack
        from pies_tpu_torch.tick_profile import device_events

        dev, smi, launches = self.dev, self.smi, self.launches
        topo, params, cfg = env
        b_ = states.members
        sampled = [b for b in ENS_SAMPLED if b < b_]
        starts = {b: unstack(states, b) for b in sampled}
        start = clone_state(states)
        total = self.counters(cfg, b_)
        secs = []
        for w in range(3):
            if w == 2:
                last = clone_state(states)  # (the traced window's start)
            self.reset()
            c = self.counters(cfg, b_)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ensemble.ensemble_tick_n(states, topo, params, cfg, 10, counters=c)
            torch.cuda.synchronize()
            sec = (time.perf_counter() - t0) / 10
            launches[label] = self.read()
            for k in c:
                total[k] += c[k]
            n = {k: v.tolist() for k, v in c.items()}
            secs.append(sec)
            t = first_tick + 10 * w
            print(f"  window {w + 1}: {sec * 1e3:.3f} ms/tick, {b_ / sec:.1f} scene-steps/s"
                  f" ({smi}; ticks {t}-{t + 9}; max residual {float(res):.4g});"
                  f" {sum(launches[label].values()) / 10:.1f} launches per tick; per member: "
                  + ", ".join(f"{k} {min(n[k])} to {max(n[k])}" for k in show))
            check(not bool(states.sim_failed.any())
                  and bool(torch.isfinite(states.positions).all()),
                  "no member latched, positions finite")
        n = {k: v.tolist() for k, v in total.items()}
        check(all(min(n[k]) > 0 for k in every), "in every member over the 30 ticks: "
              + ", ".join(f"{k} {min(n[k])} to {max(n[k])}" for k in every))
        check(all(launches[label][k] > 0 for k in detection),
              f"the detection's kernels launched: {({k: launches[label][k] for k in detection})}")
        print(f"  {label}: {min(secs) * 1e3:.3f} to {max(secs) * 1e3:.3f} ms/tick,"
              f" {b_ / max(secs):.1f} to {b_ / min(secs):.1f} scene-steps/s ({smi}); per member"
              " over the 30 ticks: " + ", ".join(f"{k} {min(n[k])} to {max(n[k])} (mean"
                                                 f" {sum(n[k]) / b_:.1f})" for k in show))
        for b, sb in starts.items():
            cb = self.counters(cfg)
            step.tick_n(sb, topo, params, cfg, 30, counters=cb)
            check(same_state(member(states, b), sb) and all(int(cb[k]) == n[k][b] for k in cb),
                  f"{self.sampled}: member {b} bit-equal to its single-scene run over the 30 ticks,"
                  f" cache and counters too ("
                  + ", ".join(f"{k} {int(cb[k])}" for k in show) + ")")
        one = stack_ensemble(unstack(start, 0), 1)
        self.reset()
        ensemble.ensemble_tick_n(one, topo, params, cfg, 10)
        torch.cuda.synchronize()
        launches[label + " B=1"] = self.read()
        live = {k: v / 10 for k, v in launches[label].items() if v}
        check(launches[label + " B=1"] == launches[label],
              f"launches per tick at B = {b_} equal those at B = 1: {sum(live.values()):.1f}"
              f" ({live})")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ensemble.ensemble_tick_n(last, topo, params, cfg, 10)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        busy = sum(us for _, us in events) / 1e3
        t = first_tick + 20
        print(f"  traced ticks {t}-{t + 9} again: wall {wall:.3f} ms, device busy {busy:.3f} ms,"
              f" idle {100 - 100 * busy / wall:.1f}% ({smi}); device time per tick by kernel:")
        for e, us in sorted(events, key=lambda eu: -eu[1])[:8]:
            print(f"    {us / 10:9.2f} us/tick  x{e.count / 10:<6.1f} {e.key[:80]}")
        return total

    def batched_twin(self, label, states, env):
        """One tick of ``states`` by the kernels and by the batched twin:
        every member's state, cache and counters bit-equal."""
        import torch

        from pies_tpu_torch.parallel import ensemble
        from pies_tpu_torch.solver import step
        from pies_tpu_torch.state import member

        topo, params, cfg = env
        e, p = clone_state(states), clone_state(states)
        c, cp = (self.counters(cfg, states.members) for _ in range(2))
        ensemble.ensemble_tick(e, topo, params, cfg, counters=c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.tick(p, topo, params, cfg, plain=True, counters=cp)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        apart = [b for b in range(states.members) if not same_state(member(e, b), member(p, b))]
        sums = {k: int(v.sum()) for k, v in c.items() if v.any()}
        check(not apart and all(torch.equal(c[k], cp[k]) for k in c),
              f"{self.sampled}: one tick of all {states.members} members of {label} bit-equal to"
              f" the batched twin, counters too ({sums}; batched twin {sec * 1e3:.1f} ms;"
              f" apart: {apart})")

    def stage_checks(self, label, states, env, count=("detection", 2), contacts=True):
        """B = 3 (member 2 latched) against the twins' member loop on the
        kernels' inputs, and B = 1 against the unbatched call; with
        ``contacts``, members 0 or 1 with contacts by the count at
        ``count`` (a stage and an output index)."""
        import torch

        from pies_tpu_torch.solver.stages import contact_stages, stages_apart
        from pies_tpu_torch.state import unstack

        topo, params, cfg = env
        st3 = first_members(states, 3)
        st3.sim_failed[2, 0] = 1
        out = contact_stages(st3, topo, params, cfg)
        torch.cuda.synchronize()
        apart = stages_apart(out, [0, 1])
        counts = out[count[0]].kernel[count[1]][:, 0].tolist()
        check(not apart and counts[2] == 0 and (max(counts[:2]) > 0 or not contacts),
              f"{self.phase}c {label}: every stage at B = 3 (member 2 latched) bit-equal to its"
              f" twins' member loop on the kernels' inputs ({', '.join(out)}; {count[0]}"
              f" {counts}; apart: {apart})")
        one = contact_stages(first_members(states, 1), topo, params, cfg, twins=False)
        alone = contact_stages(unstack(states, 0), topo, params, cfg, twins=False)
        torch.cuda.synchronize()
        check(all(torch.equal(a.reshape(b.shape), b) for stage in one
                  for a, b in zip(one[stage].kernel, alone[stage].kernel)),
              f"{self.phase}c {label}: B = 1 equals the unbatched call, every stage")

    def time_stages(self, label, states, env, names, key="ensemble_contacts"):
        """Each kernel call in ``names`` of a :func:`contact_stages` run on
        ``states`` (the twins off), on the inputs the kernel got there: at
        B = b against b launches at B = 1 on the members' views, beside its
        bound; recorded in the rows under ``key``."""
        import torch

        from pies_tpu_torch.collision import broadphase
        from pies_tpu_torch.solver.stages import contact_stages
        from pies_tpu_torch.state import member

        topo, params, cfg = env
        b_, n = states.members, states.capacity
        out = contact_stages(states, topo, params, cfg, twins=False)
        calls = {k: c for stage in out.values() for k, c in stage.calls.items()}
        torch.cuda.synchronize()
        # live contacts over the members: point-triangle, edge-edge, node pairs
        n_c = int(out["detection"].kernel[2].sum()) if "detection" in out else 0
        n_e = int(out["edge detection"].kernel[2].sum()) if "edge detection" in out else 0
        n_p = int(out["T27 setup"].kernel[0].sum()) if "T27 setup" in out else 0
        n_pairs = int(out["T20"].kernel[2].sum()) if "T20" in out else 0
        n_inc, e_ent, p_ent = 4 * n_c, 4 * n_e, 2 * n_p
        r_all = calls["T9 stage 2"][1][3].shape[-2]
        m = topo.ell_nbr.shape[0] if topo.ell_nbr is not None else 0
        passes = cfg.collision_stabilization_iterations
        full_c = cfg.contact_coupling == "full"
        # name -> (the rows it is recorded in, bytes moved once, operations)
        work = {}
        mode = broadphase.tri_mode(cfg, topo.tri_mask.shape[0])
        if "detection" in out and mode is None:
            lay = broadphase.super_layout(cfg, topo.super_corners, topo.super_adj)
            valid = int(out["cache"].kernel[1].sum())
            work["T14 without a rebuild"] = ("super_broadphase", b_ * 36 * n, b_ * 6 * n)
            work["T14 with a rebuild"] = (
                "super_broadphase", b_ * (36 * n + 8 * lay.lanes + 4) + 4 * lay.k * (lay.w + lay.a),
                b_ * 1000 * lay.k)
            work["T15"] = ("super_narrowphase",
                           b_ * (24 * n + 4 * lay.lanes + 20 * lay.cap) + 4 * lay.k * lay.w,
                           60 * len(lay.combos()) * valid)
        elif "detection" in out:
            lay = broadphase.tri_layout(cfg, topo.triangles.shape[0], mode)
            live_lanes = int(calls["T17"][1][3].sum())
            work["T16 " + mode] = (
                "tri_candidates", b_ * (24 * n + 4 * lay.t * (lay.nb + 1)) + 16 * lay.t,
                b_ * 6 * (lay.t * lay.t if mode == "allpairs" else lay.k * lay.raw))
            work["T17"] = ("tri_ccd", b_ * (4 * lay.t * (lay.nb + 1) + 24 * n + 20 * lay.cap)
                           + 12 * lay.t, 3 * 200 * live_lanes)
        if "edge detection" in out:
            lay = broadphase.tri_layout(cfg, topo.triangles.shape[0], "celllist")
            _, _, cand, count, _, _ = calls["T25"][1]
            slot = torch.arange(lay.nb, device=cand.device)
            own = torch.arange(lay.t, device=cand.device)[:, None]
            live_pairs = int(((slot < count[..., None]) & (cand > own)).sum())
            work["T16 edges"] = ("tri_candidates",
                                 b_ * (24 * n + 4 * lay.t * (lay.nb + 1)) + 16 * lay.t,
                                 b_ * 6 * lay.k * lay.raw)
            work["T25"] = ("edge_ccd", b_ * (4 * lay.t * (lay.nb + 1) + 24 * n) + 12 * lay.t
                           + 20 * n_e, 9 * 220 * live_pairs)
            work["T26 setup"] = ("edge_terms", 20 * n_e + 32 * e_ent + b_ * 24 * n, 8 * e_ent)
        if "T20" in out:
            work["T20"] = ("node_pairs", b_ * 128 * n + 16 * n_pairs, b_ * 64 * n)
            work["T27 setup"] = ("node_contacts", 12 * n_pairs + b_ * 36 * n, 2 * p_ent)
            work["T27 friction"] = ("node_contacts", 112 * n_p + b_ * 72 * n, 80 * n_p)
        work["T7 setup"] = ("pt_coupling", 20 * n_c + 24 * n_inc + b_ * 16 * n, 10 * n_inc)
        work["T7 force"] = ("pt_coupling", 20 * n_c + 24 * n_inc, 50 * n_inc)
        # (under full coupling T23 runs inside T9's stage 2 and T10; T26's
        # and T27's terms run inside T9's stage 2, T26's also in T10 under
        # full coupling and in T8)
        terms = (("pt_full",) if full_c else ()) + (("edge_terms",) if n_e or "T26 setup" in calls
                                                   else ()) + (("node_contacts",) if "T20" in out
                                                               else ())
        work["T9 stage 2"] = (("tet_force_nodes",) + terms,
                              4 * n + 4 * r_all + b_ * (52 * n + 12 * r_all) + 20 * n_c
                              + 12 * n_inc + 68 * e_ent + 40 * p_ent,
                              b_ * (3 * r_all + 12 * n) + 30 * n_inc + 150 * e_ent + 40 * p_ent)
        e_op = full_c and "T26 setup" in calls
        work["T10"] = (("ell_matvec",) + (("pt_full",) if full_c else ())
                       + (("edge_terms",) if e_op else ()),
                       8 * m * n + b_ * 32 * n + (20 * n_c + 12 * n_inc if full_c else 0)
                       + (68 * e_ent if e_op else 0),
                       b_ * (6 * m + 9) * n + (30 * n_inc if full_c else 0)
                       + (30 * e_ent if e_op else 0))
        work["T8"] = (("pt_tail", "edge_terms") if "T26 setup" in calls else "pt_tail",
                      passes * (20 * n_c + 64 * n_inc + 64 * n_e + 16 * e_ent + b_ * 28 * n)
                      + 20 * n_c + 56 * n_inc,
                      passes * (60 * n_c + 200 * n_e) + 90 * n_c)
        n_ent = topo.corner_inc.cap if topo.corner_inc is not None else 0
        work["T24"] = ("floor_entries", b_ * (36 * n + 12 * n_ent), b_ * 4 * n_ent)
        work["T4"] = ("substep_tail", 120 * b_ * n, 25 * b_ * n)
        print(f"phase {self.phase}c: {label}, each stage at B = {b_} against {b_} launches at"
              f" B = 1 ({n_c} point-triangle contacts, {n_e} edge contacts, {n_p} live node"
              f" pairs over the members; {self.smi})")
        for stage in names:
            if stage not in calls:
                continue
            fn, args = calls[stage]
            row_name, nbytes, ops = work[stage]
            per = [tuple(member(t, k) for t in args) for k in range(b_)]
            ms_b = cuda_ms(lambda: fn(*args), 10)
            ms_1 = cuda_ms(lambda: [fn(*p) for p in per], 3)
            b_ms, b_by = bound(nbytes, ops)
            print(f"  {stage}: B = {b_} {ms_b:.4f} ms, {b_} x B = 1 {ms_1:.4f} ms"
                  f" ({ms_1 / ms_b:.1f}x), bound {b_ms:.4f} ms ({b_by})")
            for name in (row_name if isinstance(row_name, tuple) else (row_name,)):
                self.rows[name].setdefault(key, {})[f"{stage}, {label}"] = dict(
                    members=b_, b_ms=ms_b, b1_x_members_ms=ms_1, bound_ms=b_ms, bound_by=b_by)


def phase16(pt, dev, smi, PD, rows, launches, reset_launches, read_launches, nine_b,
            members=ENS_DROP, pile_members=ENS_PILE, drop_res=DROP_RES, n_boxes=5):
    """Phase 16: ensembles on the generic PD path with point-triangle
    self-contact (ROADMAP item 10b-ii): 16a ``members`` x ``tet_cube_drop``
    with the bench's self-contact (the super-body detection, T14/T15) and
    16b ``pile_members`` x the box pile (all-pairs, T16/T17), each timed
    over three 10-tick windows with 16d (sampled members against their
    single-scene runs) inside; 16c every stage of the path at B = 3 against
    its twins' member loop and timed at B = ``pile_members`` against as many
    launches at B = 1: on 16a's and 16b's states, 16b's under full coupling
    on the entry-list floor, and the cell-list, reference and per-body
    branches on ``nine_b``'s states (phase 9b's folded mesh and 2b's soup:
    ``{"mesh" | "soup": (state, topology, params, config, live nodes)}``),
    then every branch and term through the ensemble tick on small scenes;
    16e a pre-latched member."""
    import torch

    from pies_tpu_torch.collision import broadphase
    from pies_tpu_torch.parallel import ensemble
    from pies_tpu_torch.scene.contact_piles import add_box_pile, branch_scene, jittered_ensemble
    from pies_tpu_torch.scene.cube_drop import add_cube_drop, lifted_ensemble
    from pies_tpu_torch.solver import pd, tetcols
    from pies_tpu_torch.state import member, unstack

    ck = EnsembleChecks(dev, smi, rows, launches, reset_launches, read_launches, "16")
    windows, batched_twin = ck.windows, ck.batched_twin
    stage_checks, time_stages = ck.stage_checks, ck.time_stages
    first, same = first_members, same_state
    t_phase = time.perf_counter()

    def lap(what):
        print(f"  ({what}: {time.perf_counter() - t_phase:.1f} s into phase 16)")

    # 16a: members x tet_cube_drop with the bench's self-contact.
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, device=dev)
    ids = add_cube_drop(s, drop_res)
    s._prepare()
    env = (s.topology, s.current_params(), s.config)
    topo, params, cfg = env
    live = len(ids)
    n_tris = int((topo.tri_mask > 0).sum())
    print(f"phase 16a: {members} x tet_cube_drop with self-contact (meshed at {drop_res}: {live}"
          f" nodes, {int((topo.strain.w > 0).sum())} tets and {n_tris} surface triangles each;"
          f" {members * live} nodes, {members * n_tris} triangles a tick), the Solver's defaults:"
          f" contact_coupling {cfg.contact_coupling}, dense_floor {cfg.dense_floor}")
    states = lifted_ensemble(s.state, members, live)
    check(not tetcols.applies(states, topo, cfg) and broadphase.super_body(cfg)
          and broadphase.tri_mode(cfg, topo.tri_mask.shape[0]) is None,
          f"the generic path with the super-body detection (super_k {cfg.super_k}), one cache"
          f" per member: pairs {tuple(states.bp.pairs.shape)}, ref {tuple(states.bp.ref.shape)}")
    seen = torch.zeros(members, dtype=torch.bool, device=dev)
    for tick in range(1, 121):
        c = pd.new_counters(dev, members)
        ensemble.ensemble_tick(states, *env, counters=c)
        seen |= c["floor_active"] > 0
        if bool(seen.all()):
            break
    else:
        raise SystemExit(f"FAILED: 16a: {int((~seen).sum())} members never on the floor")
    check(not bool(states.sim_failed.any()), f"every member has had floor-active nodes by tick"
          f" {tick}, none latched")
    lap("16a warm-up")
    total = windows("16a", states, env, tick + 1, ("super_broadphase", "super_narrowphase"))
    # The lone cube never touches itself: its contact terms add exact zeros,
    # so the members step as 15b's do without self-contact.
    off = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=False, device=dev)
    add_cube_drop(off, drop_res)
    off._prepare()
    off_states = lifted_ensemble(off.state, members, live)
    ensemble.ensemble_tick_n(off_states, off.topology, off.current_params(), off.config,
                             tick + 30)
    check(int(total["contacts"].max()) == 0
          and torch.equal(off_states.positions, states.positions)
          and torch.equal(off_states.velocities, states.velocities),
          f"16a: no contact in the windows, and after {tick + 30} ticks every member"
          " bit-equal to the same member stepped without self-contact (15b's path)")
    del off, off_states
    batched_twin("16a at B = 8", first(states, 8), env)
    drop = (states, env)
    lap("16a")

    # 16b: pile_members x phase 9a's box pile.
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, device=dev)
    add_box_pile(s, n_boxes)
    s._prepare()
    p_env = (s.topology, s.current_params(), s.config)
    p_live = s._builder.num_nodes
    p_tris = int((s.topology.tri_mask > 0).sum())
    piles = jittered_ensemble(s.state, pile_members, p_live)
    print(f"phase 16b: {pile_members} x the box pile ({n_boxes} create_boxes: {p_live} nodes and"
          f" {p_tris} triangles each; {pile_members * p_live} nodes, {pile_members * p_tris}"
          f" triangles a tick), each member jittered by ±0.02, {PILE_WARM} warm-up ticks")
    check(broadphase.tri_mode(p_env[2], s.topology.tri_mask.shape[0]) == "allpairs",
          "the generic path with the all-pairs detection")
    ensemble.ensemble_tick_n(piles, *p_env, PILE_WARM)
    total = windows("16b", piles, p_env, PILE_WARM + 1, ("tri_candidates", "tri_ccd"))
    check(int(total["contacts"].min()) > 0, f"point-triangle contacts in every member in the"
          f" window (device counters): {int(total['contacts'].min())} to"
          f" {int(total['contacts'].max())} contact-substeps a member")
    batched_twin("16b", piles, p_env)
    lap("16b")

    # 16c: every stage against the twins, at B = 3 and B = 1, and timed at B.
    states, env = drop
    # (a lone cube has no self-contact: its detection runs and finds none)
    stage_checks("16a's state (super-body, T14/T15)", states, env, contacts=False)
    main_stages = ["T14 without a rebuild", "T14 with a rebuild", "T15", "T16 allpairs", "T17",
                   "T7 setup", "T7 force", "T9 stage 2", "T10", "T8", "T4"]
    time_stages(f"16a's state ({members} x tet_cube_drop)", states, env, main_stages)
    stage_checks("16b's state (all-pairs, T16/T17)", piles, p_env)
    time_stages(f"16b's state ({pile_members} x the box pile)", piles, p_env, main_stages)
    # Full coupling on the entry-list floor (T23 in T9's stage 2 and T10, T24)
    # for one substep of 16b's state.
    f_env = p_env[:2] + (dataclasses.replace(p_env[2], contact_coupling="full",
                                             dense_floor=False),)
    stage_checks("16b's state, full coupling on the entry-list floor (T23, T24)", piles, f_env)
    time_stages(f"16b's state ({pile_members} x the box pile), full coupling on the entry-list"
                f" floor", piles, f_env, ["T24", "T9 stage 2", "T10"])
    lap("16c on 16a's and 16b's states")
    # The cell-list, reference and per-body branches at phase 9b's sizes: the
    # folded 110,592-node mesh with phase 9b's cell-list overrides (and
    # broadphase_mode="reference"), and phase 2b's 125,000-tet soup with the
    # packed layout off, each member jittered.
    mesh9, soup9 = nine_b["mesh"], nine_b["soup"]
    for kind, (st9, topo9, params9, cfg9, live9) in (
            ("celllist", mesh9), ("reference", mesh9[:3] + (dataclasses.replace(
                mesh9[3], broadphase_mode="reference"),) + mesh9[4:]), ("bodies", soup9)):
        st9 = clone_state(st9)
        st9.bp = None  # (the per-triangle branches keep no cache)
        b_env = (topo9, params9, cfg9)
        big = jittered_ensemble(st9, pile_members, live9, seed0=100)
        check(broadphase.tri_mode(cfg9, topo9.tri_mask.shape[0]) == kind
              and not tetcols.applies(big, topo9, cfg9),
              f"16c {kind} at phase 9b's size: {live9} nodes and"
              f" {int((topo9.tri_mask > 0).sum())} triangles a member, the generic path")
        stage_checks(f"{kind} at phase 9b's size", big, b_env)
        time_stages(f"{kind} at phase 9b's size, B = {pile_members}", big, b_env,
                    ["T16 " + kind, "T17", "T7 setup", "T7 force", "T9 stage 2", "T10", "T8",
                     "T4"])
        del big, st9
        torch.cuda.empty_cache()
    lap("16c at phase 9b's sizes")
    # Every branch and term through the ensemble tick on small scenes (its
    # launches), each stage against its twins there too.
    for kind in ("super", "celllist", "reference", "bodies", "full_entry"):
        b_s, b_cfg = branch_scene(kind, dev)
        b_env = (b_s.topology, b_s.current_params(), b_cfg)
        b_states = jittered_ensemble(b_s.state, 3, b_s._builder.num_nodes, seed0=100)
        ensemble.ensemble_tick_n(b_states, *b_env, BRANCH_WARM[kind])
        reset_launches()
        ensemble.ensemble_tick_n(clone_state(b_states), *b_env, 1)
        torch.cuda.synchronize()
        launches["16c " + kind] = read_launches()
        mode = broadphase.tri_mode(b_cfg, b_s.topology.tri_mask.shape[0])
        check(mode == {"full_entry": "allpairs", "super": None}.get(kind, kind),
              f"16c {kind}: the {mode or 'super-body'} detection, contact_coupling"
              f" {b_cfg.contact_coupling},"
              f" dense_floor {b_cfg.dense_floor}")
        stage_checks(f"{kind} ({b_s._builder.num_nodes} nodes a member)", b_states, b_env)
    lap("16c")

    # 16e: a member latched before the start stays frozen, with contacts on.
    e4 = jittered_ensemble(s.state, 4, p_live)
    ensemble.ensemble_tick_n(e4, *p_env, PILE_WARM)
    e4.sim_failed[2, 0] = 1
    start, others = unstack(e4, 2), [unstack(e4, b) for b in (0, 1, 3)]
    c = pd.new_counters(dev, 4)
    ensemble.ensemble_tick_n(e4, *p_env, 40, counters=c)
    latched = (e4.sim_failed != 0).any(dim=-1).tolist()
    n = {k: v.tolist() for k, v in c.items()}
    print(f"phase 16e: 4 x the box pile from tick {PILE_WARM + 1}, member 2 latched, 40 ticks:"
          f" latched {latched}, contacts {n['contacts']}, CG trips {n['cg_trips']}")
    check(same(member(e4, 2), start) and all(n[k][2] == 0 for k in n),
          "the latched member is bit-unchanged, its cache too, and counts nothing")
    check(latched == [False, False, True, False] and min(n["contacts"][:2] + n["contacts"][3:]) > 0
          and all(not torch.equal(member(e4, b).positions, o.positions)
                  for b, o in zip((0, 1, 3), others))
          and bool(torch.isfinite(e4.positions).all()),
          "the others step in contact, unlatched and finite")
    lap("16e")



def phase17(pt, dev, smi, PD, rows, launches, reset_launches, read_launches, nets12b,
            members=ENS_NETS, nets_nn=NETS_NN, cloud=ENS_CLOUD, big_members=ENS_BIG):
    """Phase 17: ensembles on the generic PD path with edge-edge and PD
    node-node contacts (ROADMAP item 10b-iii): 17a ``members`` x
    ``edge_nets`` and 17b ``cloud`` (nodes, members) PD node clouds, each
    timed over three 10-tick windows with 17d (sampled members against
    their single-scene runs) inside; 17c every stage of those paths at B =
    3 against its twins' member loop (on 17a's state in both quirk modes,
    17b's, and the tet boxes with all three contact families under
    recentered coupling) and timed at B against as many launches at B = 1
    on 17a's and 17b's states and at B = ``big_members`` on ``nets12b``
    (phase 12b's full-width nets: ``(state, topology, params, config,
    live nodes)``); 17d one tick of 8 members against the batched twin and
    a pre-latched member with edge-edge and node-node contacts on."""
    import torch

    from pies_tpu_torch.parallel import ensemble
    from pies_tpu_torch.scene.contact_piles import branch_scene, jittered_ensemble
    from pies_tpu_torch.scene.edge_nets import nets_ensemble
    from pies_tpu_torch.scene.pbd_scenes import cloud_ensemble
    from pies_tpu_torch.solver import pd, tetcols
    from pies_tpu_torch.state import member, unstack

    ck = EnsembleChecks(dev, smi, rows, launches, reset_launches, read_launches, "17")
    t_phase = time.perf_counter()

    def lap(what):
        print(f"  ({what}: {time.perf_counter() - t_phase:.1f} s into phase 17)")

    def per_member(total, keys):
        return "; ".join(f"{k} {total[k].tolist()}" for k in keys)

    edge_stages = ["T16 edges", "T25", "T26 setup", "T9 stage 2", "T10", "T8"]
    node_stages = ["T20", "T27 setup", "T9 stage 2", "T27 friction", "T4"]

    # 17a: members x edge_nets at the bench's size.
    s, states = nets_ensemble(members, nets_nn, dev)
    env = (s.topology, s.current_params(), s.config)
    topo, params, cfg = env
    live = s._builder.num_nodes
    n_tris = int((topo.tri_mask > 0).sum())
    print(f"phase 17a: {members} x edge_nets (nn = {nets_nn}: {live} nodes and {n_tris}"
          f" triangles each; {members * live} nodes, {members * n_tris} triangles a tick),"
          f" edge_nets.solver_args(): contact_coupling {cfg.contact_coupling}, reference_quirks"
          f" {cfg.reference_quirks}, caps {cfg.budget.max_edge_contacts}; each member jittered"
          " by ±0.02")
    check(not tetcols.applies(states, topo, cfg) and pd.edge_contact(cfg, topo),
          "the generic path with edge-edge and point-triangle contacts")
    # A probe past the window (reruns are bit-identical): each member's first
    # tick with edge contacts and its latch tick.
    probe = clone_state(states)
    first_t = torch.full((members,), -1, dtype=torch.int64, device=dev)
    latch_t = first_t.clone()
    for t in range(1, NETS_PROBE + 1):
        c = pd.new_counters(dev, members)
        ensemble.ensemble_tick(probe, *env, counters=c)
        first_t = torch.where((first_t < 0) & (c["edge_contacts"] > 0), t, first_t)
        latch_t = torch.where((latch_t < 0) & (probe.sim_failed != 0).any(-1), t, latch_t)
    first_l, latch_l = first_t.tolist(), latch_t.tolist()
    del probe
    end = min([t for t in latch_l if t > 0], default=NETS_PROBE + 1) - 1
    start = min(NETS_DENSE - 1, end - 30)
    print(f"  a probe of {NETS_PROBE} ticks: first edge contacts per member at ticks {first_l};"
          f" latch ticks per member (-1: none) {latch_l}")
    check(0 <= start and start + 30 <= end and max(first_l) > 0,
          f"the window, ticks {start + 1}-{start + 30}, ends before the first latch (tick"
          f" {end + 1}) and every member has had edge contacts (by tick {max(first_l)})")
    ensemble.ensemble_tick_n(states, *env, start)
    lap("17a probe and warm-up")
    total = ck.windows("17a", states, env, start + 1, ("tri_candidates", "edge_ccd", "edge_terms"),
                       every=("edge_contacts",),
                       show=("edge_contacts", "edge_hits", "contacts", "cg_trips"))
    print("  17a per member over the 30 ticks:"
          f" {per_member(total, ('edge_contacts', 'edge_hits'))}")
    ck.batched_twin("17a at B = 8", first_members(states, 8), env)
    lap("17a")

    # 17b: PD node clouds at the bench's pile size.
    cloud_n, cloud_members = cloud
    c_s, cl = cloud_ensemble(cloud_members, cloud_n, dev)
    c_env = (c_s.topology, c_s.current_params(), c_s.config)
    print(f"phase 17b: {cloud_members} PD node clouds (add_node_pile, {cloud_n} nodes each, seed"
          f" 3; {cloud_members * cloud_n} nodes a tick), node-node contacts on, cap"
          f" {c_env[2].budget.max_node_node_contacts}; each member jittered by ±0.02")
    check(not tetcols.applies(cl, *c_env[::2]) and c_env[2].enable_node_collisions,
          "the generic path with node-node contacts")
    seen = torch.zeros(cloud_members, dtype=torch.bool, device=dev)
    for tick in range(1, 41):
        c = pd.new_counters(dev, cloud_members)
        ensemble.ensemble_tick(cl, *c_env, counters=c)
        seen |= c["touching_pairs"] > 0
        if bool(seen.all()):
            break
    check(bool(seen.all()) and not bool(cl.sim_failed.any()),
          f"every member has touching pairs by tick {tick}, none latched")
    total = ck.windows("17b", cl, c_env, tick + 1, ("node_pairs", "node_contacts"),
                       every=("node_pairs", "touching_pairs"),
                       show=("node_pairs", "touching_pairs", "cg_trips", "floor_active"))
    print(f"  17b per member over the 30 ticks: {per_member(total, ('touching_pairs',))}")
    ck.batched_twin("17b at B = 8", first_members(cl, 8), c_env)
    lap("17b")

    # 17c: every stage against the twins at B = 3 and B = 1, and timed.
    ck.stage_checks("17a's state (edge_nets, full coupling)", states, env,
                    count=("edge detection", 2))
    q_env = env[:2] + (dataclasses.replace(cfg, reference_quirks=True),)
    ck.stage_checks("17a's state in quirk mode (reference_quirks=True)", states, q_env,
                    count=("edge detection", 2))
    ck.stage_checks("17b's state (PD node clouds)", cl, c_env, count=("T27 setup", 0))
    a_s, a_cfg = branch_scene("all_on", dev)
    a_env = (a_s.topology, a_s.current_params(), a_cfg)
    a_states = jittered_ensemble(a_s.state, 4, a_s._builder.num_nodes, seed0=100)
    ensemble.ensemble_tick_n(a_states, *a_env, ALL_ON_WARM)
    reset_launches()
    c = pd.new_counters(dev, 4)
    ensemble.ensemble_tick(clone_state(a_states), *a_env, counters=c)
    torch.cuda.synchronize()
    launches["17c all_on"] = read_launches()
    n = {k: v.tolist() for k, v in c.items()}
    check(all(min(n[k]) > 0 for k in ("contacts", "edge_contacts", "touching_pairs")),
          "17c all_on: the tet boxes with point-triangle, edge-edge and node-node contacts,"
          f" recentered coupling ({a_s._builder.num_nodes} nodes a member), all three live in"
          f" every member at tick {ALL_ON_WARM + 1}: contacts {n['contacts']}, edge contacts"
          f" {n['edge_contacts']}, node pairs {n['node_pairs']}, touching {n['touching_pairs']}")
    ck.stage_checks("all_on (tet boxes, every contact family)", a_states, a_env,
                    count=("edge detection", 2))
    lap("17c checks")
    ck.time_stages(f"17a's state ({members} x edge_nets)", states, env, edge_stages,
                   key="ensemble_edges")
    ck.time_stages(f"17b's state ({cloud_members} PD node clouds)", cl, c_env, node_stages,
                   key="ensemble_edges")
    del states, cl
    torch.cuda.empty_cache()
    st12, topo12, params12, cfg12, live12 = nets12b
    big = jittered_ensemble(st12, big_members, live12, seed0=100)
    ck.time_stages(f"phase 12b's nets (nn = 256, {live12} nodes a member)", big,
                   (topo12, params12, cfg12), edge_stages, key="ensemble_edges")
    del big
    torch.cuda.empty_cache()
    lap("17c")

    # 17d: a member latched before the start stays frozen, both families on:
    # 4 x the 6 x 6 nets with node-node contacts too, recentered coupling,
    # ticks 1-40 (edge contacts from tick ~15, before the nets' latch).
    d_s, d4 = nets_ensemble(4, 6, dev, seed0=100, contact_coupling="recentered",
                            enable_node_collisions=True)
    d_env = (d_s.topology, d_s.current_params(), d_s.config)
    d4.sim_failed[2, 0] = 1
    start_2, others = unstack(d4, 2), [unstack(d4, b) for b in (0, 1, 3)]
    c = pd.new_counters(dev, 4)
    ensemble.ensemble_tick_n(d4, *d_env, 40, counters=c)
    latched = (d4.sim_failed != 0).any(dim=-1).tolist()
    n = {k: v.tolist() for k, v in c.items()}
    print(f"phase 17d: 4 x the 6 x 6 nets with node-node contacts, member 2 latched, 40 ticks:"
          f" latched {latched}, edge contacts {n['edge_contacts']}, node pairs"
          f" {n['node_pairs']}")
    check(same_state(member(d4, 2), start_2) and all(n[k][2] == 0 for k in n),
          "the latched member is bit-unchanged and counts nothing")
    live3 = [0, 1, 3]
    check(latched == [False, False, True, False]
          and all(min(n[k][b] for b in live3) > 0 for k in ("edge_contacts", "node_pairs"))
          and all(not torch.equal(member(d4, b).positions, o.positions)
                  for b, o in zip(live3, others))
          and bool(torch.isfinite(d4.positions).all()),
          "the others step with edge-edge contacts and node pairs, unlatched and finite")
    lap("17d")

def pbd_stage_work(name, states, env, out):
    """``(row, bytes, operations)`` of a :func:`pbd_stages` call at the
    ensemble's member count: the bytes moved once (the topology read once,
    each member's nodes, rows and pairs once) and the float32 operations."""
    topo, params, cfg = env
    b_, n = states.members, states.capacity
    pairs = int(out["T20"].kernel[2].sum()) if "T20" in out else 0
    k4 = {"position": 1, "distance": 1, "strain": 4, "bend": 4}
    kind = name.split()[-1]
    c = getattr(topo, kind).idx.shape[0] if kind in k4 else 0
    if name.startswith("T18 rows"):
        shared, per, ops = {"position": (20, 28, 8), "distance": (16, 40, 20),
                            "strain": (64, 112, 1500), "bend": (24, 128, 200)}[kind]
        return "pbd_constraints", shared * c + b_ * per * c, b_ * ops * c
    if name.startswith("T18 apply"):
        e = c * k4[kind]
        return "pbd_constraints", 4 * (n + 1) + 4 * e + b_ * (24 * n + 16 * e), b_ * 4 * (e + n)
    if name == "T19 chains":
        links, chains = topo.chains.idx0.numel(), topo.chains.idx0.shape[0]
        return ("pbd_distance_seq", 12 * links + 4 * chains + b_ * (24 * links + 12 * chains),
                b_ * 45 * links)
    if name == "T19 colours":
        c = topo.distance.idx.shape[0]
        return "pbd_distance_seq", 16 * c + b_ * 36 * c, b_ * 25 * c
    return {"T18 head": ("pbd_constraints", b_ * 52 * n, b_ * 9 * n),
            "T18 floor": ("pbd_constraints", b_ * 20 * n, b_ * 3 * n),
            "T18 tail": ("pbd_constraints", b_ * 68 * n, b_ * 25 * n),
            "T20 without a rebuild": ("node_pairs", b_ * 24 * n, b_ * 6 * n),
            "T20 with a rebuild": ("node_pairs", b_ * 128 * n + 16 * pairs, b_ * 64 * n),
            "T21": ("node_response", b_ * 68 * n + 12 * pairs, 140 * pairs)}[name]


def phase18(pt, dev, smi, rows, launches, reset_launches, read_launches, members=ENS_PBD,
            bench=PBD_BENCH, soup_tets=ENS_TETS, small=4):
    """Phase 18: PBD ensembles (ROADMAP item 10b-iv): 18a ``members`` x
    ``rope_pbd`` (``bench[0]`` nodes each), 18b ``members`` x
    ``pbd_node_pile`` (``bench[1]``), 18c ``members`` x the 512-tet soup
    (``soup_tets``) under the PBD solver, collisions off, each timed over
    three 10-tick windows with 18e (sampled members against their
    single-scene runs, and 8 members against the batched twin) inside; 18d
    every stage of ``solver/stages.pbd_stages`` at B = 3 against its twins'
    member loop and B = 1 against the unbatched call on those states, the
    net and the bend sheet (``small`` members each), and timed at B against
    B launches at B = 1 on 18a's, 18b's and 18c's states; 18f a pre-latched
    member of ``small`` ropes frozen over 40 ticks."""
    import torch

    from pies_tpu_torch.parallel import ensemble
    from pies_tpu_torch.scene.pbd_scenes import (
        add_net, pbd_ensemble, pile_ensemble, rope_ensemble)
    from pies_tpu_torch.solver import pbd
    from pies_tpu_torch.solver.stages import PBD_ROUNDOFF, PBD_WHOLE, pbd_stages, stages_apart
    from pies_tpu_torch.state import member, unstack

    ck = EnsembleChecks(dev, smi, rows, launches, reset_launches, read_launches, "18", "e")
    t_phase = time.perf_counter()
    show = ("floor_active", "pairs", "touching", "rebuilds")
    kernels4 = ("pbd_constraints", "pbd_distance_seq", "node_pairs", "node_response")

    def lap(what):
        print(f"  ({what}: {time.perf_counter() - t_phase:.1f} s into phase 18)")

    def warm(label, states, env, first, keys, least=1, cap=60):
        """``first`` ticks at once, then tick by tick (at least ``least``)
        until every member has had each counter of ``keys`` above 0;
        returns the ticks run and the tick-by-tick part's rebuilds per tick
        and member."""
        b_ = states.members
        if first:
            ensemble.ensemble_tick_n(states, *env, first)
        seen = torch.zeros((len(keys), b_), dtype=torch.bool, device=dev)
        per_tick = []
        for t in range(1, cap + 1):
            c = pbd.new_counters(dev, b_)
            ensemble.ensemble_tick(states, *env, counters=c)
            for i, k in enumerate(keys):
                seen[i] |= c[k] > 0
            per_tick.append(c["rebuilds"])
            if t >= least and bool(seen.all()):
                break
        per_tick = torch.stack(per_tick).tolist()
        check(bool(seen.all()) and not bool(states.sim_failed.any())
              and bool(torch.isfinite(states.positions).all()),
              f"{label}: every member has had {', '.join(keys)} by tick {first + t}, none"
              " latched, positions finite")
        return first + t, per_tick

    def stage_checks(label, states, env):
        """B = 3 (member 1 latched) against the twins' member loop, B = 1
        against the unbatched call."""
        st3 = first_members(states, 3)
        st3.sim_failed[1, 0] = 1
        out = pbd_stages(st3, *env)
        torch.cuda.synchronize()
        apart = stages_apart(out, [0, 2], PBD_WHOLE, PBD_ROUNDOFF)
        touch = out["T21"].kernel[2][:, 0].tolist() if "T21" in out else None
        check(not apart and (touch is None or (touch[1] == 0 and max(touch[0], touch[2]) > 0)),
              f"18d {label}: every stage at B = 3 (member 1 latched) equal to its twins' member"
              f" loop on the kernels' inputs, bend rows within 1e-6 ({', '.join(out)};"
              f" touching pairs {touch}; apart: {apart})")
        one = pbd_stages(first_members(states, 1), *env, twins=False)
        alone = pbd_stages(unstack(states, 0), *env, twins=False)
        torch.cuda.synchronize()
        check(all(torch.equal(a.reshape(b.shape), b) for stage in one
                  for a, b in zip(one[stage].kernel, alone[stage].kernel)),
              f"18d {label}: B = 1 equals the unbatched call, every stage")

    def time_stages(label, states, env):
        """Each kernel call of a ``pbd_stages`` run at B = members against
        as many launches at B = 1 on the members' views, beside its bound;
        recorded in the rows under ``ensemble_pbd``."""
        b_ = states.members
        out = pbd_stages(states, *env, twins=False)
        calls = {k: c for stage in out.values() for k, c in stage.calls.items()}
        torch.cuda.synchronize()
        print(f"phase 18d: {label}, each stage at B = {b_} against {b_} launches at B = 1 ({smi})")
        for name, (fn, args) in calls.items():
            row_name, nbytes, ops = pbd_stage_work(name, states, env, out)
            per = [tuple(member(t, k) for t in args) for k in range(b_)]
            ms_b = cuda_ms(lambda: fn(*args), 10)
            ms_1 = cuda_ms(lambda: [fn(*p) for p in per], 3)
            b_ms, b_by = bound(nbytes, ops)
            print(f"  {name}: B = {b_} {ms_b:.4f} ms, {b_} x B = 1 {ms_1:.4f} ms"
                  f" ({ms_1 / ms_b:.1f}x), bound {b_ms:.4f} ms ({b_by})")
            rows[row_name].setdefault("ensemble_pbd", {})[f"{name}, {label}"] = dict(
                members=b_, b_ms=ms_b, b1_x_members_ms=ms_1, bound_ms=b_ms, bound_by=b_by)

    # 18a: members x rope_pbd at the bench's size.
    s, ropes = rope_ensemble(members, bench[0], dev)
    r_env = (s.topology, s.current_params(), s.config)
    print(f"phase 18a: {members} x rope_pbd ({bench[0]} nodes each, {bench[0] // 128} pinned"
          f" ropes of 128, w 0.9, collisions on; {members * bench[0]} nodes a tick), distance"
          f" form {'chains' if s.config.distance_chain else 'not chains'}; each member"
          " jittered by ±0.02")
    check(s.config.distance_chain and ropes.nn is not None and ropes.nn.pi.shape[0] == members,
          "the chain walk and a node-pair cache per member")
    tick, per_tick = warm("18a", ropes, r_env, 35, ("floor_active", "touching"))
    differ = [t for t, r in enumerate(per_tick) if len(set(r)) > 1]
    rebuilding = [sum(map(bool, r)) for r in per_tick]
    print(f"  ticks 36-{tick}: members with a rebuild per tick {rebuilding}; ticks whose rebuild"
          f" counts differ between members: {len(differ)}")
    lap("18a warm-up")
    total = ck.windows("18a", ropes, r_env, tick + 1, kernels4, every=("touching",), show=show)
    # (a swinging rope meets the floor now and then: floor nodes in all)
    check(int(total["floor_active"].sum()) > 0 and int(total["pairs"].min()) > 0,
          f"18a: floor-active nodes over the 30 ticks ({total['floor_active'].tolist()}), live"
          " pairs in every member")
    print(f"  18a per member over the 30 ticks: rebuilds {total['rebuilds'].tolist()}")
    ck.batched_twin("18a at B = 8", first_members(ropes, 8), r_env)
    lap("18a")

    # 18b: members x pbd_node_pile at the bench's size.
    p_s, piles = pile_ensemble(members, bench[1], dev)
    p_env = (p_s.topology, p_s.current_params(), p_s.config)
    print(f"phase 18b: {members} x pbd_node_pile ({bench[1]} nodes each, seed 3, collisions on;"
          f" {members * bench[1]} nodes a tick); each member jittered by ±0.02")
    tick, per_tick = warm("18b", piles, p_env, 0, ("floor_active", "touching"), least=10)
    differ = [t + 1 for t, r in enumerate(per_tick) if len(set(r)) > 1]
    check(bool(differ), f"18b: members rebuild their caches on their own iterations: ticks"
          f" {differ} of 1-{tick} have rebuild counts that differ between members (tick 1:"
          f" {sorted(set(per_tick[0]))})")
    lap("18b warm-up")
    total = ck.windows("18b", piles, p_env, tick + 1, ("pbd_constraints", "node_pairs",
                                                       "node_response"),
                       every=("floor_active", "touching"), show=show)
    print(f"  18b per member over the 30 ticks: rebuilds {total['rebuilds'].tolist()}")
    ck.batched_twin("18b at B = 8", first_members(piles, 8), p_env)
    lap("18b")

    # 18c: members x the ensemble_vmap soup under PBD, collisions off.
    c_s, soups = pbd_ensemble(lambda s_: s_.create_tet_soup(soup_tets, **PBD_SOUP), members, dev,
                              enable_collisions=False, reference_quirks=False)
    c_env = (c_s.topology, c_s.current_params(), c_s.config)
    live = c_s._builder.num_nodes
    print(f"phase 18c: {members} x the {soup_tets}-tet soup under PBD ({live} nodes each,"
          f" {members * live} a tick; strain w 1.0, reference_quirks=False, collisions off);"
          " each member jittered by ±0.02")
    tick, _ = warm("18c", soups, c_env, 0, ("floor_active",))
    lap("18c warm-up")
    ck.windows("18c", soups, c_env, tick + 1, ("pbd_constraints",), every=("floor_active",),
               show=("floor_active",))
    ck.batched_twin("18c at B = 8", first_members(soups, 8), c_env)
    lap("18c")

    # 18d: every stage against the twins, and timed.
    stage_checks("18a's state (rope_pbd: pins, chains, T20, T21)", ropes, r_env)
    stage_checks("18b's state (pbd_node_pile: T20, T21)", piles, p_env)
    stage_checks("18c's state (the soup: strain, reference_quirks=False)", soups, c_env)
    q_env = c_env[:2] + (dataclasses.replace(c_env[2], reference_quirks=True),)
    stage_checks("18c's state in quirk mode (reference_quirks=True)", soups, q_env)
    n_s, nets = pbd_ensemble(add_net, small, dev, enable_collisions=False)
    n_env = (n_s.topology, n_s.current_params(), n_s.config)
    ensemble.ensemble_tick_n(nets, *n_env, 5)
    check(len(n_env[2].distance_colors) > 1, "the net takes the colour classes")
    stage_checks(f"the 8 x 8 net ({len(n_env[2].distance_colors)} colour classes)", nets, n_env)
    b_s, sheets = pbd_ensemble(lambda s_: s_.create_bend_sheet((0, 2.0, 0), 0.5, w=0.1), small,
                               dev, enable_collisions=False)
    b_env = (b_s.topology, b_s.current_params(), b_s.config)
    ensemble.ensemble_tick_n(sheets, *b_env, 5)
    stage_checks(f"create_bend_sheet ({b_s.topology.bend.idx.shape[0]} bends)", sheets, b_env)
    lap("18d checks")
    time_stages(f"18a's state ({members} x rope_pbd)", ropes, r_env)
    time_stages(f"18b's state ({members} x pbd_node_pile)", piles, p_env)
    time_stages(f"18c's state ({members} PBD soups)", soups, c_env)
    del ropes, piles, soups
    torch.cuda.empty_cache()
    lap("18d")

    # 18f: a member latched before the start stays frozen.
    f_s, f4 = rope_ensemble(small, bench[0], dev, seed0=100)
    f_env = (f_s.topology, f_s.current_params(), f_s.config)
    f4.sim_failed[2, 0] = 1
    start_2, others = unstack(f4, 2), [unstack(f4, b) for b in range(small) if b != 2]
    c = pbd.new_counters(dev, small)
    ensemble.ensemble_tick_n(f4, *f_env, 40, counters=c)
    latched = (f4.sim_failed != 0).any(dim=-1).tolist()
    n = {k: v.tolist() for k, v in c.items()}
    print(f"phase 18f: {small} x rope_pbd, member 2 latched, 40 ticks: latched {latched},"
          f" counters {n}")
    check(same_state(member(f4, 2), start_2) and all(n[k][2] == 0 for k in n),
          "the latched member is bit-unchanged, its cache too, and counts nothing")
    rest = [b for b in range(small) if b != 2]
    check(latched == [b == 2 for b in range(small)]
          and all(min(n[k][b] for b in rest) > 0 for k in ("touching", "rebuilds"))
          and all(not torch.equal(member(f4, b).positions, o.positions)
                  for b, o in zip(rest, others))
          and bool(torch.isfinite(f4.positions).all()),
          "the others step with touching pairs and cache rebuilds, unlatched and finite")
    lap("18f")


def tetcol_stages(states, topo, params, cfg, kernel):
    """One tet-column substep's outputs on a copy of ``states``, every stage
    by the kernels (``kernel``) or every stage by the twins: T3, the
    detection (T16/T17 on a per-triangle branch), T7's setup and force, T1,
    T2, T8 and T4 (``tests/test_torch_ensemble.py``'s stages)."""
    import numpy as np
    import torch

    from pies_tpu_torch.constraints import projections as proj
    from pies_tpu_torch.solver import pd, tetcols

    st = clone_state(states)
    pick = (lambda k, p: k) if kernel else (lambda k, p: p)  # noqa: E731
    out = {}
    x, msn, diag, wf, active = out["T3"] = pick(pd.substep_head, pd.substep_head_plain)(
        st, topo, params, cfg, True)
    colls = pd.detect_point_tri(st, x, topo, params, cfg, active, plain=not kernel)
    out["T16/T17"] = (colls.pt_idx, colls.pt_mask, colls.pt_count, colls.overflow)
    h2 = float(np.float32(params.dt) * np.float32(params.dt))
    inc, ptd = pick(tetcols.pt_coupling_setup, tetcols.pt_coupling_setup_plain)(
        colls, st.mass, topo, h2, diag, wf, st.sim_failed)
    live = colls.pt_count > 0
    on = (inc.row_start[..., 1:] > inc.row_start[..., :-1]) & live
    out["T7 setup"] = (torch.where(live, inc.row_start, 0), torch.where(on, ptd, 0.0), diag)
    f0 = pick(proj.tet_force12, proj.tet_force12_plain)(x, topo.strain, topo.volume,
                                                        st.sim_failed)
    out["T1"] = (f0,)
    contact = pick(tetcols.pt_force, tetcols.pt_force_plain)(x, colls, inc,
                                                             params.collision_thickness,
                                                             st.sim_failed)
    out["T7 force"] = (torch.where(on[..., None], contact, 0.0),)
    plane = pd.floor_plane(params, cfg.reference_quirks)
    x_new, stat, r2 = out["T2"] = pick(tetcols.substep_cols, tetcols.substep_cols_plain)(
        x, msn, diag, st.node_mask, wf, topo, plane, 1, st.sim_failed,
        (ptd, contact, inc.row_start, colls.pt_count))
    fric = pick(pd.pt_tail, pd.pt_tail_plain)(st, params, cfg, colls, inc, x_new, stat)
    out["T8"] = (x_new, st.prev_positions.clone(), torch.where(on[..., None], fric, 0.0))
    pick(pd.substep_tail, pd.substep_tail_plain)(st, topo, params, active, x_new, stat, colls,
                                                 inc, fric)
    out["T4"] = (st.positions, st.velocities, st.forces, st.sim_failed)
    return out, st


def phase19(pt, dev, smi, PD, rows, launches, reset_launches, read_launches,
            members=ENS_MEMBERS, n_tets=ENS_TETS):
    """Phase 19: tet-column ensembles with self-contact off the packed bodies
    (ROADMAP item 10c): ``members`` x the 512-tet soup of phase 13 (seeded
    +-0.02 offsets) in reference mode (19 reference) and with a budget that
    unpacks the bodies, on the cell list (19 celllist); each warmed into
    contact, three timed ``ensemble_tick_n(10)`` windows with the sampled
    members against their single-scene runs and the launches per tick at B
    = members against B = 1 (``EnsembleChecks.windows``); then every stage
    at B = 3, member 1 latched, against its twin."""
    import dataclasses

    import torch

    from pies_tpu_torch.collision import broadphase
    from pies_tpu_torch.parallel import ensemble
    from pies_tpu_torch.scene.contact_piles import SUPER_OFF, jittered_ensemble
    from pies_tpu_torch.solver import tetcols

    ck = EnsembleChecks(dev, smi, rows, launches, reset_launches, read_launches, "19")
    t_phase = time.perf_counter()
    for mode in ("reference", "celllist"):
        label = f"19 {mode}"
        s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, device=dev,
                      broadphase_mode=mode)
        s.create_tet_soup(n_tets, **SCENE)
        s._prepare()
        cfg = s.config
        if mode == "celllist":
            cfg = dataclasses.replace(
                cfg, body_nodes=0, body_node_offset=0, body_faces=(), allpairs_broadphase_max=0,
                budget=dataclasses.replace(cfg.budget, body_stride=1, max_narrow_candidates=32),
                **SUPER_OFF)
        env = (s.topology, s.current_params(), cfg)
        states = jittered_ensemble(s.state, members, s._builder.num_nodes, seed0=0)
        check(tetcols.applies(states, *env[::2]) and broadphase.tri_mode(
            cfg, s.topology.tri_mask.shape[0]) == mode,
              f"{label}: {members} x {n_tets}-tet soups on the tet-column path, the {mode}"
              " detection")
        ensemble.ensemble_tick_n(states, *env, CONTACT_WARMUP)
        print(f"phase {label}: {members} x {n_tets} tets, {CONTACT_WARMUP} warm-up ticks")
        ck.windows(label, states, env, CONTACT_WARMUP + 1, ("tri_candidates", "tri_ccd"),
                   every=("floor_active",), show=("contacts", "floor_active"))
        st3 = first_members(states, 3)
        st3.sim_failed[1, 0] = 1
        k, k_state = tetcol_stages(st3, *env, True)
        p, p_state = tetcol_stages(st3, *env, False)
        torch.cuda.synchronize()
        apart = [name for name in k for a, b in zip(k[name], p[name])
                 if not all(torch.equal(a[m], b[m]) for m in (0, 2))]
        counts = k["T16/T17"][2][:, 0].tolist()
        frozen = all(torch.equal(getattr(k_state, f)[1], getattr(st3, f)[1])
                     for f in ("positions", "prev_positions", "velocities"))
        check(not apart and counts[1] == 0 and min(counts[0], counts[2]) > 0 and frozen,
              f"{label}: every stage at B = 3 (member 1 latched, frozen) equal to its twin for"
              f" members 0 and 2 ({', '.join(k)}; contacts {counts}; apart: {apart})")
        del states, st3, k, p, s
        print(f"  ({label}: {time.perf_counter() - t_phase:.1f} s into phase 19)")


def domain_partition(domain, state, topo, want, margin, label):
    """The domain of ``state`` in ``want`` slabs, or in the largest count
    below it that the partitioner accepts (a halo wider than a block);
    returns ``(domain, slabs)``."""
    for d in range(want, 1, -1):
        try:
            return domain.partition_domain(clone_state(state), topo, d,
                                           collision_margin=margin), d
        except ValueError as e:
            print(f"  {label}: {d} slabs refused ({e})")
    raise SystemExit(f"FAILED: {label}: no slab count from {want} down to 2 accepted")


def domain_counts(domain, dom, params, cfg, label, row):
    """The slabs' contact counts, each slab on its view with its emit mask
    (T16/T17, T25, T20), summed: ``{kind: count}``; of the node pairs the
    touching ones, as a list of node-id pairs in the original numbering (a
    pair is any two nodes sharing a hash bucket, so the rest depend on the
    grid's table size, which a slab's view sets).  Each slab's detection is
    held to its twins on the same inputs (the main path's shapes), and on
    an inner slab the emit-masked launch is timed beside its twin: T16 on
    the point-triangle scene, T25 on the edge scene, T20 on the node
    cloud, each a row ``"<kernel> (emit)"`` of ``label``."""
    import numpy as np
    import torch

    from pies_tpu_torch.collision import broadphase
    from pies_tpu_torch.parallel import halo
    from pies_tpu_torch.state import empty_node_pair_cache

    meta, st, sc = dom.meta, dom.state, dom.static
    b, l, v = meta.halo, meta.block, meta.view
    dev = st.positions.device
    h = float(np.float32(params.dt))
    mask = sc.node_mask_view[:, b:b + l, None]
    xv = halo.refresh(st.positions + h * st.velocities * mask, b)
    pv = halo.refresh(st.prev_positions, b)
    dcfg = domain.domain_config(cfg)
    failed = st.sim_failed
    zero = lambda: torch.zeros(1, dtype=torch.int32, device=dev)  # noqa: E731
    out, held = {}, []
    tris = sc.triangles.shape[1] > 0
    timed = min(1, meta.n_slabs - 1)  # (an inner slab where there is one)
    for s in range(meta.n_slabs):
        emit = sc.tri_emit_mask[s]
        if dcfg.enable_collisions and tris:
            k, p = (broadphase.detect_point_tri_collisions(
                xv[s], pv[s], sc.tri_mask[s], params, dcfg, failed=failed, plain=plain,
                triangles=sc.triangles[s], emit=emit) for plain in (False, True))
            held.append(("T16/T17", all(torch.equal(a, c) for a, c in zip(k, p))))
            out["contacts"] = out.get("contacts", 0) + int(k[2][0])
            if s == timed and label == "20b":
                mode = broadphase.tri_mode(dcfg, sc.tri_mask.shape[1])
                lay = broadphase.tri_layout(dcfg, sc.tri_mask.shape[1], mode)
                scal = broadphase.tri_scalars(params, dcfg)
                c16 = lambda fn: fn(  # noqa: E731
                    xv[s], pv[s], sc.triangles[s], sc.tri_mask[s], lay, scal, zero(), failed, emit)
                n_emit = int(((emit > 0) & (sc.tri_mask[s] > 0)).sum())
                # Positions at both times and the triangles read once, the
                # rows written; the emitting rows compare their gathered
                # candidates' boxes (6 float comparisons each).
                row("tri_candidates (emit)", "pies_tpu_torch/kernels/csrc/tri_candidates.cu",
                    "pies_tpu/collision/broadphase.py:1410", 0.0,
                    cuda_ms(lambda: c16(broadphase.tri_candidates), 10),
                    cuda_ms(lambda: c16(broadphase.tri_candidates_plain), 2), "equal",
                    24 * v + 16 * lay.t + 4 * lay.t * (lay.nb + 1), 6 * n_emit * lay.raw)
        if dcfg.enable_edge_collisions and tris:
            k, p = (broadphase.detect_edge_edge_collisions(
                xv[s], pv[s], sc.triangles[s], sc.tri_mask[s], params, dcfg, zero(), failed,
                plain, emit) for plain in (False, True))
            held.append(("T16/T25", all(torch.equal(a, c) for a, c in zip(k, p))))
            out["edge_hits"] = out.get("edge_hits", 0) + int(k[3][0])
            if s == timed and label == "20d":
                lay = broadphase.tri_layout(dcfg, sc.tri_mask.shape[1], "celllist")
                ov = zero()
                cand, count, flags = broadphase.tri_candidates(
                    xv[s], pv[s], sc.triangles[s], sc.tri_mask[s], lay,
                    broadphase.tri_scalars(params, dcfg), ov, failed)
                args = (xv[s], pv[s], sc.triangles[s], cand, count, flags,
                        dcfg.budget.max_edge_contacts, dcfg.reference_quirks, failed, emit)
                t_rows, nb = cand.shape
                slot = torch.arange(nb, device=dev)[None, :]
                own = torch.arange(t_rows, device=dev)[:, None]
                live_pairs = int(((slot < count[:, None]) & (cand > own)
                                  & (emit[:, None] > 0)).sum())
                n_e = int(k[2][0])
                row("edge_ccd (emit)", "pies_tpu_torch/kernels/csrc/edge_ccd.cu",
                    "pies_tpu/collision/broadphase.py:1499", 0.0,
                    cuda_ms(lambda: broadphase.edge_ccd(*args), 20),
                    cuda_ms(lambda: broadphase.edge_ccd_plain(*args), 2), "equal",
                    4 * t_rows * nb + 16 * t_rows + 24 * v + 20 * n_e, 9 * 220 * live_pairs)
        if dcfg.enable_node_collisions:
            nk, np_ = (broadphase.detect_node_node_pairs(
                xv[s], sc.radius_view[s], sc.node_mask_view[s], params, dcfg, failed, plain,
                emit=sc.node_emit[s]) for plain in (False, True))
            n = int(np_.count[0])
            held.append(("T20", int(nk.count[0]) == n and all(
                torch.equal(getattr(nk, f)[:n], getattr(np_, f)[:n])
                for f in ("pi", "pj", "inc_pair")) and all(
                torch.equal(getattr(nk, f), getattr(np_, f))
                for f in ("row_off", "inc_start", "ref"))))
            base = s * meta.block - meta.halo  # view slot v is new node base + v
            out.setdefault("touching_pairs", []).extend(
                frozenset(int(dom.perm[base + u]) for u in p)
                for p in touching(nk, xv[s], sc.radius_view[s]))
            if s == timed and label == "20c":
                cc = empty_node_pair_cache(v, dcfg.budget.max_candidates_per_node, dev)

                def rebuild(fn):
                    cc.fresh.zero_()
                    fn(xv[s], sc.radius_view[s], sc.node_mask_view[s], cc, params, dcfg, failed,
                       sc.node_emit[s])

                row("node_pairs (emit)", "pies_tpu_torch/kernels/csrc/node_pairs.cu",
                    "pies_tpu/collision/broadphase.py:1966", 0.0,
                    cuda_ms(lambda: rebuild(broadphase.node_pairs), 20),
                    cuda_ms(lambda: rebuild(broadphase.node_pairs_plain), 3), "equal",
                    52 * v + 12 * n, 0)
    torch.cuda.synchronize()
    kinds = sorted({k for k, _ in held})
    if held:
        check(all(ok for _, ok in held),
              f"{label}: each of the {meta.n_slabs} slabs' emit-masked detection"
              f" ({', '.join(kinds)}) equal to its twins on the same view")
    return out


def hold_stages(domain, dom, params, cfg, label, row):
    """One domain substep on a copy of ``dom``'s state, at the main path's
    shapes, with T8 (``pt_tail``) and T27's friction (``node_friction``) in
    their accumulate-only modes and T4 (``tail``) with the friction at
    every node each held to its twin on the inputs of the call, then timed
    beside it: rows ``"pt_tail (acc)"`` and ``"substep_tail (fric_all)"``
    on the point-triangle scene, ``"node_contacts (acc)"`` on the node
    cloud (``label``).  Returns the stages held."""
    import torch

    from pies_tpu_torch.solver import pd
    from pies_tpu_torch.state import clone_state as clone

    kern, plain = pd._KERNELS, pd._PLAIN
    held = {}
    v_all = dom.meta.n_slabs * dom.meta.view
    n_own = dom.meta.n_slabs * dom.meta.block

    def pt_tail(*a):
        got, ref = kern["pt_tail"](*a), plain["pt_tail"](*a)
        torch.cuda.synchronize()
        stage = "stabilize" if a[9] == pd.STABILIZE else "friction"
        held.setdefault(f"T8 {stage}", []).append(torch.equal(got, ref))
        colls = a[3]
        if label == "20b" and stage == "friction" and a[4] is not None:
            n_c = int(colls.pt_count[0])
            # The contacts and the view's positions, masses and velocities
            # read once, the sums written; ~90 operations a contact.
            row("pt_tail (acc)", "pies_tpu_torch/kernels/csrc/pt_tail.cu",
                "pies_tpu/solver/pd.py:526", 0.0, cuda_ms(lambda: kern["pt_tail"](*a), 20),
                cuda_ms(lambda: plain["pt_tail"](*a), 3), "equal", 20 * n_c + 60 * v_all,
                90 * n_c)
        return got

    def node_friction(*a):
        got, ref = kern["node_friction"](*a), plain["node_friction"](*a)
        torch.cuda.synchronize()
        held.setdefault("T27 friction", []).append(all(torch.equal(x, y)
                                                       for x, y in zip(got, ref)))
        if label == "20c":
            n_p = int(a[3].lim[0])
            row("node_contacts (acc)", "pies_tpu_torch/kernels/csrc/node_contacts.cu",
                "pies_tpu/solver/pd.py:452", 0.0, cuda_ms(lambda: kern["node_friction"](*a), 20),
                cuda_ms(lambda: plain["node_friction"](*a), 3), "equal",
                112 * n_p + 72 * v_all, 80 * n_p)
        return got

    def tail(state, *a):
        twin = clone(state)
        plain["tail"](twin, *a)
        kern["tail"](state, *a)
        torch.cuda.synchronize()
        fields = ("positions", "prev_positions", "velocities", "forces", "sim_failed")
        held.setdefault("T4" + (" fric_all" if a[-1] else ""), []).append(
            all(torch.equal(getattr(state, f), getattr(twin, f)) for f in fields))
        if label == "20b" and a[-1]:
            row("substep_tail (fric_all)", "pies_tpu_torch/kernels/csrc/substep_ends.cu",
                "pies_tpu/parallel/domain.py:955", 0.0, cuda_ms(lambda: kern["tail"](twin, *a), 20),
                cuda_ms(lambda: plain["tail"](twin, *a), 5), "equal", 120 * n_own, 25 * n_own)

    ops = domain._Ops(False, dom.meta.halo)
    ops.k = dict(kern, pt_tail=pt_tail, node_friction=node_friction, tail=tail)
    domain._substep(clone(dom.state), dom.static, params, domain.domain_config(cfg), dom.meta,
                    ops, True, None)
    torch.cuda.synchronize()
    check(held and all(all(v) for v in held.values()),
          f"{label}: one domain substep at the main path's shapes with each of"
          f" {', '.join(f'{k} ({len(v)})' for k, v in held.items())} equal to its twin on the"
          " inputs of its call")
    return held


def hold_operator(dom, state, topo, params, label):
    """The domain's CG operator and its dot product at the main path's
    shapes against the single scene's, on one seeded vector ``p``: T30's
    refresh, T10 over the flat views and T30's reduce (the slabs' view-local
    rows, offsets and halo sums) against T10 over the single scene
    (``topo``, the generic path's), within 1e-5 of the largest entry; the
    reduce's p·Ap block partials against the float64 dot of the single
    scene's ``p`` and ``Ap`` over its nodes, within 1e-5.  A lost or doubled
    halo term parts them by a constraint's weight, a halo slot in the dot
    by its share of the nodes; float32 sums in another order part them by
    a few ulps.  (A whole tick amplifies those ulps about twentyfold: its
    check is against the single scene's own one-ulp spread.)"""
    import torch

    from pies_tpu_torch.parallel import domain
    from pies_tpu_torch.solver import assembly, pd

    meta = dom.meta
    d, l = meta.n_slabs, meta.block
    dev = state.positions.device
    n = state.positions.shape[0]
    gen = torch.Generator(device=dev).manual_seed(20)
    p = torch.randn((n, 3), generator=gen, device=dev) * state.node_mask[:, None]
    _, h2 = pd._h_h2(params)
    failed = torch.zeros(2, dtype=torch.int32, device=dev)
    y1, _ = assembly.apply_system(p, state.mass, torch.zeros(n, device=dev), h2, topo, failed)
    p_own = torch.zeros((d * l, 3), device=dev)
    p_own[:n] = p[torch.from_numpy(dom.perm).to(dev).long()]
    y_own, part = domain.operator(dom, params)(p_own, True)
    y = y_own[torch.from_numpy(dom.inv_perm).to(dev).long()]
    torch.cuda.synchronize()
    scale = float(y1.abs().max())
    err = float((y - y1).abs().max())
    dot1 = float((p.double() * y1.double()).sum())
    dot = float(part.double().sum())
    check(err <= 1e-5 * scale and abs(dot - dot1) <= 1e-5 * abs(dot1),
          f"{label}: the domain's operator (refresh, T10 over the {d} views, reduce) on one"
          f" vector within 1e-5 of the largest entry ({scale:.4e}) of the single scene's T10"
          f" (max |dy| {err:.3e}, {max_ulp(y, y1):.0f} ulp), its p.Ap partials within 1e-5 of"
          f" the single scene's float64 dot ({dot:.9e} against {dot1:.9e})")


def touching(nn, x, radius) -> list:
    """The touching pairs ``(i, j)`` of a pair prefix: |x_j - x_i| <= r_i +
    r_j."""
    import torch

    n = int(nn.count[0])
    i, j = nn.pi[:n].long(), nn.pj[:n].long()
    hit = torch.linalg.vector_norm(x[j] - x[i], dim=-1) <= radius[i] + radius[j]
    return list(zip(i[hit].tolist(), j[hit].tolist()))


def single_counts(domain, state, topo, params, cfg):
    """The same counts of the single scene, on the same predicted positions
    under the domain's detection branch."""
    import numpy as np
    import torch

    from pies_tpu_torch.collision import broadphase

    dcfg = domain.domain_config(cfg)
    h = float(np.float32(params.dt))
    x = state.positions + h * state.velocities * state.node_mask[:, None]
    prev, failed = state.prev_positions, state.sim_failed
    out = {}
    tris = topo.triangles.shape[0] > 0
    if dcfg.enable_collisions and tris:
        out["contacts"] = int(broadphase.detect_point_tri_collisions(
            x, prev, topo.tri_mask, params, dcfg, failed=failed, triangles=topo.triangles)[2][0])
    if dcfg.enable_edge_collisions and tris:
        ov = torch.zeros(1, dtype=torch.int32, device=x.device)
        out["edge_hits"] = int(broadphase.detect_edge_edge_collisions(
            x, prev, topo.triangles, topo.tri_mask, params, dcfg, ov, failed)[3][0])
    if dcfg.enable_node_collisions:
        nn = broadphase.detect_node_node_pairs(x, state.radius, state.node_mask, params, dcfg,
                                               failed)
        out["touching_pairs"] = [frozenset(p) for p in touching(nn, x, state.radius)]
    return out


def phase20(pt, dev, smi, PD, row, rows, launches, reset_launches, read_launches, keep,
            cloud_n=CLOUD_N, nets_nn=NETS_NN, small_tets=16_384, twin_slabs=(3, 8), keep21=None):
    """Phase 20: the spatial domain decomposition on one card (ROADMAP item
    11a): 20a phase 5's mesh in 8 slabs (floor contact), 20b phase 3b's
    soup with self-contact in 4 (the cell list), 20c phase 12c's PD node
    cloud in 4, 20d the crossing nets in 2 (edge-edge contacts under full
    coupling); each: every slab's emit-masked detection (T16/T17, T25,
    T20) and one substep's accumulate-only T8 and T27 friction and T4 with
    the friction at every node held to their twins at the scene's own
    shapes, and timed (rows ``"<kernel> (emit)"``, ``"(acc)"``,
    ``"(fric_all)"``); the domain's CG operator and p·Ap partials on one
    vector against the single scene's within 1e-5 (``hold_operator``); one
    domain tick against the single scene's tick from the same state (the
    generic path's Jacobi CG, the domain's detection branch) within 1e-5
    or twice the single scene's own one-ulp spread, and against the same
    tick in one slab (printed); the slabs' contact counts summed against
    the single scene's on identical inputs, three timed 10-tick windows
    beside the single scene's ms/tick, launches per tick and the device's
    idle share; 20e the domain ticks by the kernels against the twins (every
    kernel of the slice on the path, T30 and the emit masks and the
    accumulate-only modes among them) at ``twin_slabs`` slabs on small
    scenes, T30 held to its twins and timed on 20a's shapes; 20f a NaN in
    one slab latches every slab.  ``keep21`` receives 20a's and 20b's
    scenes, partitions, single-scene ticks, bounds and ms/tick (phase 21).

    20c's cloud is phase 12c's at ``CLOUD_DENSITY`` nodes per unit volume
    instead of ~23: a node pair is any two nodes sharing a hash bucket of the
    padded boxes, gathered up to 32 candidates a node in bucket order, and
    at phase 12c's density that budget binds, so which pairs a node keeps
    depends on the numbering (the slabs' and the single scene's differ, in
    the JAX package too); at this density it does not bind, and the pairs
    that touch are the same.  Distant cells still collide in the hash
    table, so 20c's one tick against the single scene (and the one slab)
    is printed, not held."""
    import dataclasses

    import torch

    from pies_tpu_torch.parallel import domain, halo
    from pies_tpu_torch.scene.edge_nets import add_crossing_nets, solver_args
    from pies_tpu_torch.scene.pbd_scenes import add_node_pile
    from pies_tpu_torch.solver import pd, step
    from pies_tpu_torch.tick_profile import device_events
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    cells = {}  # each scene's slabs, ms/tick beside the single scene's, launches, idle share

    def lap(what):
        print(f"  ({what}: {time.perf_counter() - t_phase:.1f} s into phase 20)")

    def generic(cfg, topo):
        """The single scene on the generic path with Jacobi and the domain's
        detection branch: the algorithm the domain runs."""
        return (dataclasses.replace(domain.domain_config(cfg), tet_cols=False),
                dataclasses.replace(topo, tet_block6=None))

    def margin_of(state, topo, params, cfg):
        """The partitioner's collision margin: the CCD threshold, twice the
        largest triangle extent (a swept triangle) and the node pairs'
        reach, 2 (r + 0.5) + a cell, as the scene's contacts need."""
        m = 0.0
        if topo.triangles.shape[0] and (cfg.enable_collisions or cfg.enable_edge_collisions):
            live = topo.tri_mask > 0
            p = state.positions[topo.triangles[live].long()]
            ext = float((p.amax(1) - p.amin(1)).max())
            m = params.collision_threshold_distance + 2.0 * ext
        if cfg.enable_node_collisions:
            m = max(m, 2.0 * (float(state.radius.max()) + 0.5) + params.grid_spacing)
        return m

    def run(label, state, topo, params, cfg, want, names, gate, n_live):
        margin = margin_of(state, topo, params, cfg)
        t0 = time.perf_counter()
        dom, d = domain_partition(domain, state, topo, want, margin, label)
        meta = dom.meta
        print(f"phase {label}: {d} slabs of {meta.block} owned nodes, halo {meta.halo}, margin"
              f" {margin:.3f} ({n_live} live nodes; partition {time.perf_counter() - t0:.2f} s)")
        gcfg, gtopo = generic(cfg, topo)

        def tagged(name, *args):
            """``row``, the row's launches read from this scene's window."""
            row(name, *args)
            rows[name]["timed_on"] = label

        dc = domain_counts(domain, dom, params, cfg, label, tagged)
        sc_ = single_counts(domain, state, topo, params, cfg)
        pairs, single_pairs = dc.pop("touching_pairs", []), set(sc_.pop("touching_pairs", []))
        check(dc == sc_, f"{label}: the slabs' contact counts summed equal the single scene's on"
              f" identical inputs: {dc} (each contact emitted by exactly one slab)")
        if cfg.enable_node_collisions:
            # Each node's candidates stop at 32 in bucket order, and a bucket
            # holds the entries of every cell hashed to it: which pairs a
            # crowded node keeps depends on the grid, so a slab may find a
            # touching pair the single scene's grid dropped.
            found = set(pairs)
            check(len(found) == len(pairs) and single_pairs <= found,
                  f"{label}: every touching pair of the single scene ({len(single_pairs)}) found by"
                  f" exactly one slab on identical inputs ({len(pairs)} found, none twice;"
                  f" {len(found - single_pairs)} more than the single scene's grid kept)")
        hold_stages(domain, dom, params, cfg, label, tagged)
        hold_operator(dom, state, gtopo, params, label)
        tick = domain.make_domain_tick(cfg, meta)
        single = clone_state(state)
        step.tick(single, gtopo, params, gcfg)
        # The same tick in one slab: the domain's spatial order, and so the
        # CG's dot products summed in the same order as the slabs' (no halo
        # exchange); the slabs part from it where the halo reduce sums a
        # node's terms in another order, which the tick amplifies as it does
        # a one-ulp move of its input (printed).
        dom1 = domain.partition_domain(clone_state(state), topo, 1, collision_margin=margin)
        domain.make_domain_tick(cfg, dom1.meta)(dom1.state, dom1.static, params)
        tick(dom.state, dom.static, params)
        got = torch.from_numpy(domain.gather_positions(dom, dom.state)[:n_live]).to(dev)
        err = float((got - single.positions[:n_live]).abs().max())
        err1 = float((got - torch.from_numpy(domain.gather_positions(dom1, dom1.state)[:n_live])
                      .to(dev)).abs().max())
        del dom1
        # The single scene's own float32 spread: its tick from the state with
        # half the live coordinates moved one ulp (phase 11d's measure); the
        # domain sums the CG's dot products in another order (the spatial
        # numbering), which is such a move.
        gen = torch.Generator(device=dev).manual_seed(20)
        u = clone_state(state)
        live = u.node_mask[:, None] > 0
        moved = (torch.rand(u.positions.shape, generator=gen, device=dev) < 0.5) & live
        up = torch.rand(u.positions.shape, generator=gen, device=dev) < 0.5
        u.positions.copy_(torch.where(moved, torch.nextafter(
            u.positions, torch.where(up, float("inf"), float("-inf"))), u.positions))
        step.tick(u, gtopo, params, gcfg)
        spread = float((u.positions[:n_live] - single.positions[:n_live]).abs().max())
        tol = max(1e-5, 2.0 * spread)
        if cfg.enable_node_collisions:
            # A node pair is any two nodes whose padded boxes share a hash
            # bucket, and distant cells collide in the table: the single
            # scene's pairs include such far pairs, a slab's view cannot
            # (the JAX domain's neither), and every pair adds its weight to
            # the system.  So the one tick is printed, and the pairs that
            # touch are what is held (above).
            print(f"  {label}: one domain tick against the single scene's from the same state:"
                  f" max |dx| {err:.3e}, against the same tick in one slab {err1:.3e} (the far"
                  f" hash-bucket pairs differ; the single scene's one-ulp spread {spread:.3e})")
        else:
            print(f"  {label}: one domain tick in {d} slabs against the same tick in one slab:"
                  f" max |dx| {err1:.3e}")
            check(err <= tol, f"{label}: one domain tick within {tol:.3e} (1e-5, or twice the"
                  f" single scene's own one-ulp spread {spread:.3e}) of the single scene's"
                  f" generic Jacobi tick from the same state (max |dx| {err:.3e})")
        secs = []
        for w in range(3):
            reset_launches()
            c = pd.new_counters(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                tick(dom.state, dom.static, params, c)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / 10)
            launches[label] = read_launches()
            counts = {k: int(v) for k, v in c.items() if int(v)}
            check(not dom.state.sim_failed.any() and bool(torch.isfinite(dom.state.positions)
                                                          .all()),
                  f"{label} window {w + 1}: {secs[-1] * 1e3:.3f} ms/tick ({smi}), no slab"
                  f" latched, finite; counters {counts}")
        check(all(counts.get(g, 0) > 0 for g in gate), f"{label}: {', '.join(gate)} live")
        check(all(launches[label][n] > 0 for n in names),
              f"{label}: every kernel of the path launched: "
              + ", ".join(f"{n} {launches[label][n] / 10:.1f}/tick" for n in names))
        per_tick = sum(launches[label].values()) / 10
        s_state = clone_state(state)
        step.tick(s_state, topo, params, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.tick_n(s_state, topo, params, cfg, 10)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 100
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                tick(dom.state, dom.static, params)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        busy = sum(us for _, us in events) / 1e3
        halo_us = sum(us for e, us in events if "halo" in e.key or "refresh" in e.key
                      or "reduce_kernel" in e.key or "merge" in e.key)
        print(f"  {label}: domain {min(secs) * 1e3:.3f} to {max(secs) * 1e3:.3f} ms/tick, single"
              f" scene {single_ms:.3f} ms/tick ({smi}); {per_tick:.1f} launches per tick; traced"
              f" window: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle"
              f" {100 - 100 * busy / wall:.1f}%, T30 {halo_us / 1e3:.3f} ms"
              f" ({100 * halo_us / 1e3 / max(busy, 1e-9):.1f}% of busy)")
        for e, us in sorted(events, key=lambda eu: -eu[1])[:6]:
            print(f"    {us / 10:9.2f} us/tick  x{e.count / 10:<6.1f} {e.key[:80]}")
        if keep21 is not None and label in ("20a", "20b"):
            keep21[label] = dict(dom=dom, state=state, topo=topo, params=params, config=cfg,
                                 n_live=n_live, margin=margin, tol=tol, ms=min(secs) * 1e3,
                                 single=single.positions[:n_live].cpu(), one_card=got.cpu())
        cells[label] = dict(one_tick_dx=err, one_slab_dx=err1, single_spread=spread,
            slabs=d, block=meta.block, halo=meta.halo, ms_per_tick=min(secs) * 1e3,
            single_ms_per_tick=single_ms, launches_per_tick=per_tick,
            idle_share=1 - busy / wall, halo_share=halo_us / 1e3 / max(busy, 1e-9))
        return dom, tick

    path = ["substep_head", "halo_refresh", "halo_reduce", "tet_force_nodes", "ell_matvec",
            "pcg", "substep_tail"]
    # 20a: phase 5's mesh at tick 75 (floor contact), no self-contact.
    warm, topo_a, params_a, cfg_a, live_a = keep.pop("20a")
    dom_a, tick_a = run("20a", warm, topo_a, params_a, cfg_a, 8, path,
                        ("floor_active", "cg_trips"), live_a)
    del warm
    lap("20a")
    # 20b: phase 3b's soup at the start of its contact window, self-contact (the cell
    # list, with the 32 narrow slots a row of the cell list's own budget: the
    # packed bodies' 16 latch the piled soup's rows within ~20 ticks).
    st, topo, params, cfg = keep.pop("20b")
    cfg = dataclasses.replace(cfg, budget=dataclasses.replace(cfg.budget,
                                                              max_narrow_candidates=32))
    run("20b", st, topo, params, cfg, 4, path + ["tri_candidates", "tri_ccd", "pt_coupling",
                                                 "pt_tail", "halo_merge"],
        ("contacts", "floor_active"),
        int((st.node_mask > 0).sum()))
    del st, topo
    lap("20b")
    # 20c: phase 12c's PD node cloud.
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=False,
                  enable_node_collisions=True,
                  budget_overrides=dict(max_node_node_contacts=32 * cloud_n // 2), device=dev)
    add_node_pile(s, cloud_n, math.sqrt(cloud_n / (5.5 * CLOUD_DENSITY)) / 2)
    s._prepare()
    run("20c", s.state, s.topology, s.current_params(), s.config, 4,
        path + ["node_pairs", "node_contacts", "halo_merge"], ("node_pairs", "touching_pairs"),
        s._builder.num_nodes)
    del s
    lap("20c")
    # 20d: the crossing nets from their first edge contact (the single
    # scene's), so that the windows end before the dense phase (tick ~48).
    s = pt.Solver(pt.SolverOptions(solver=PD), device=dev, **solver_args())
    add_crossing_nets(s, nets_nn)
    s._prepare()
    for first in range(1, NETS_DENSE + 1):
        c = pd.new_counters(dev)
        x = clone_state(s.state)
        step.tick(x, s.topology, s.current_params(), s.config, counters=c)
        if int(c["edge_contacts"]):
            break
        s._state = x
    print(f"phase 20d: the nets' first edge contacts on tick {first}")
    run("20d", s.state, s.topology, s.current_params(), s.config, 2,
        path + ["tri_candidates", "tri_ccd", "edge_ccd", "edge_terms", "pt_full", "pt_tail",
                "halo_merge"],
        ("edge_contacts",), s._builder.num_nodes)
    del s
    lap("20d")

    # 20e: the domain ticks by the kernels against the twins on small scenes.
    done = set()

    def twin_tick(label, state, topo, params, cfg, want, ticks=2):
        dom, d = domain_partition(domain, state, topo, want, margin_of(state, topo, params, cfg),
                                  label)
        if (label, d) in done:  # (a refused count fell back to one already run)
            return None
        done.add((label, d))
        dom2, _ = domain_partition(domain, state, topo, d, margin_of(state, topo, params, cfg),
                                   label)
        k_tick = domain.make_domain_tick(cfg, dom.meta)
        p_tick = domain.make_domain_tick(cfg, dom.meta, plain=True)
        ck, cp = pd.new_counters(dev), pd.new_counters(dev)
        for _ in range(ticks):
            k_tick(dom.state, dom.static, params, ck)
            p_tick(dom2.state, dom2.static, params, cp)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(dom.state, f), getattr(dom2.state, f))
                   for f in ("positions", "prev_positions", "velocities", "shape_quats",
                             "sim_failed"))
        counts = {k: int(v) for k, v in ck.items() if int(v)}
        check(same and all(torch.equal(ck[k], cp[k]) for k in ck),
              f"20e {label} in {d} slabs: {ticks} domain ticks by the kernels bit-equal to the"
              f" twins, counters too ({counts})")
        return counts

    soup = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, device=dev)
    soup.create_tet_soup(small_tets, **SCENE)
    soup.run_ticks(CONTACT_WARMUP)
    cloud = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=False,
                      enable_node_collisions=True,
                      budget_overrides=dict(max_node_node_contacts=16 * 8192), device=dev)
    add_node_pile(cloud, 8192, math.sqrt(8192 / (5.5 * CLOUD_DENSITY)) / 2)  # (20c's density)
    cloud._prepare()
    nets = pt.Solver(pt.SolverOptions(solver=PD), device=dev, **solver_args())
    add_crossing_nets(nets, nets_nn)
    nets._prepare()
    nets.run_ticks(NETS_DENSE)
    for d in twin_slabs:
        for label, s in (("soup", soup), ("cloud", cloud), ("nets", nets)):
            twin_tick(f"{label} ({small_tets if label == 'soup' else s._builder.num_nodes}"
                      " nodes)" if label != "soup" else f"soup ({small_tets} tets)", s.state,
                      s.topology, s.current_params(), s.config, d)
    del soup, cloud, nets
    lap("20e twins")

    # T30 on 20a's shapes: each mode against its twin, timed beside its bound
    # and the library's gather / scatter-add of the same values.
    meta = dom_a.meta
    dd, ll, bb, vv = meta.n_slabs, meta.block, meta.halo, meta.view
    gen = torch.Generator(device=dev).manual_seed(20)
    own3 = torch.randn((dd, ll, 3), device=dev, generator=gen)
    view3 = torch.randn((dd, vv, 3), device=dev, generator=gen)
    view4 = torch.rand((dd, vv, 4), device=dev, generator=gen) * 3
    idx = torch.arange(dd * vv, device=dev)
    slab, slot = idx // vv, idx % vv
    src = slab * ll + slot - bb  # the refresh's gather from the flat owned nodes
    src_ok = (src >= 0) & (src < dd * ll)
    src = torch.where(src_ok, src, 0)
    dst_own = (slab * ll + slot - bb).clamp(0, dd * ll - 1)
    checks = {
        "refresh": (lambda: halo.refresh(own3, bb), lambda: halo.refresh_plain(own3, bb)),
        "reduce": (lambda: halo.reduce(view3, bb), lambda: halo.reduce_plain(view3, bb)),
        "reduce p.Ap": (lambda: halo.reduce(view3, bb, p=own3),
                        lambda: halo.reduce_plain(view3, bb, p=own3)),
        "average": (lambda: halo.reduce(view4, bb, halo.AVERAGE),
                    lambda: halo.reduce_plain(view4, bb, halo.AVERAGE)),
    }
    for name, (fk, fp) in checks.items():
        a, b_ = fk(), fp()
        a, b_ = (a if isinstance(a, tuple) else (a,)), (b_ if isinstance(b_, tuple) else (b_,))
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b_)),
              f"20e T30 {name} at D = {dd}, L = {ll}, B = {bb}: equal to its twin")
    x0, p0 = torch.randn((dd, ll, 3), device=dev, generator=gen), torch.randn(
        (dd, ll, 3), device=dev, generator=gen)
    act = (torch.rand((dd, ll), device=dev, generator=gen) < 0.1).float()
    stat = torch.randn((dd, ll, 3), device=dev, generator=gen)
    ok_failed = torch.zeros(2, dtype=torch.int32, device=dev)
    xa, pa, xb, pb = x0.clone(), p0.clone(), x0.clone(), p0.clone()
    halo.reduce(view4, bb, halo.APPLY, x_own=xa, prev_own=pa, active=act, stat=stat,
                failed=ok_failed)
    halo.reduce_plain(view4, bb, halo.APPLY, x_own=xb, prev_own=pb, active=act, stat=stat,
                      failed=ok_failed)
    torch.cuda.synchronize()
    check(torch.equal(xa, xb) and torch.equal(pa, pb), "20e T30 apply: equal to its twin")
    ms_r = cuda_ms(lambda: halo.refresh(own3, bb), 50)
    lib_r = cuda_ms(lambda: own3.reshape(-1, 3).index_select(0, src), 50)
    row("halo_refresh", "pies_tpu_torch/kernels/csrc/halo.cu",
        "pies_tpu/parallel/domain.py:581", 0.0, ms_r,
        cuda_ms(lambda: halo.refresh_plain(own3, bb), 10), "equal",
        4 * dd * (ll + vv) * 3, 0, lib_r)  # (each input read once, each output written once)
    ms_d = cuda_ms(lambda: halo.reduce(view3, bb), 50)
    lib_d = cuda_ms(lambda: torch.zeros((dd * ll, 3), device=dev).index_add_(
        0, dst_own, view3.reshape(-1, 3)), 50)
    row("halo_reduce", "pies_tpu_torch/kernels/csrc/halo.cu",
        "pies_tpu/parallel/domain.py:596", 0.0, ms_d,
        cuda_ms(lambda: halo.reduce_plain(view3, bb), 10), "equal",
        4 * dd * (vv + ll) * 3, 3 * dd * ll, lib_d)
    cap = 4096
    src = torch.randint(0, vv, (dd, cap, 4), device=dev, dtype=torch.int32, generator=gen)
    smask = torch.ones((dd, cap), device=dev)
    counts = torch.randint(0, cap + 1, (dd, 1), device=dev, dtype=torch.int32, generator=gen)
    mk, mp = halo.merge(src, smask, counts, cap, vv), halo.merge_plain(src, smask, counts, cap, vv)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(mk, mp)),
          f"20e T30 merge of {dd} lists of {cap} contacts ({int(mk[2][0])} live): equal to its"
          " twin")
    row("halo_merge", "pies_tpu_torch/kernels/csrc/halo.cu",
        "pies_tpu/parallel/domain.py:706", 0.0,
        cuda_ms(lambda: halo.merge(src, smask, counts, cap, vv), 50),
        cuda_ms(lambda: halo.merge_plain(src, smask, counts, cap, vv), 5), "equal",
        dd * cap * 20 + 4 * dd + dd * cap * 20, 0)
    rows["halo_refresh"]["domain_cells"] = cells
    rows["halo_reduce"]["modes_ms"] = {
        "p.Ap partials": cuda_ms(lambda: halo.reduce(view3, bb, p=own3), 50),
        "average k=4": cuda_ms(lambda: halo.reduce(view4, bb, halo.AVERAGE), 50)}
    lap("20e T30")

    # 20f: a NaN planted in one slab latches every slab; the next tick is a no-op.
    ds, st_ = dom_a.state, dom_a.static
    b_nan = dd // 2
    node = int((st_.own.node_mask.view(dd, ll)[b_nan] > 0).nonzero()[0, 0])
    check(not bool(ds.sim_failed.any()), "20f: no slab latched before")
    ds.positions[b_nan, node, 0] = float("nan")
    tick_a(ds, st_, params_a)
    bits = lambda t: t.view(torch.int32).clone()  # noqa: E731  (NaN-proof equality)
    before = [bits(getattr(ds, f)) for f in ("positions", "prev_positions", "velocities")]
    tick_a(ds, st_, params_a)
    torch.cuda.synchronize()
    after = [bits(getattr(ds, f)) for f in ("positions", "prev_positions", "velocities")]
    check(bool(ds.failed_slabs().all()) and int(ds.sim_failed[0]) == 1
          and all(torch.equal(a, b) for a, b in zip(before, after)),
          f"20f: a NaN in slab {b_nan} of {dd} latched every slab ({ds.failed_slabs().tolist()});"
          " the next tick left the state bit for bit")
    lap("20f")


R21 = 4  # phase 21's ranks, all on the one card (gloo)
NAN_RANK = 2  # 21c: the rank whose slab gets the NaN
RANK_ROWS = ("halo_refresh (outer bands)", "halo_reduce (outer bands)", "pcg (ranks)")


def hold_t11(diag, mask, world, dev, seed, reps=50):
    """T11's split stages alone (``assembly.cg_update``, ``cg_direction``)
    at one rank's shapes: ``N`` owned nodes (``diag``, ``mask``), partials
    of ``parts = world·P`` with this launch's P blocks at the last rank's
    slice, the other ranks' partials seeded.  One trip is held to its twin
    (``assembly.cg_trip_plain``, totals over the same R·P partials); then
    ``reps`` trips in a row (no exit test, every trip live) are timed by
    CUDA events, and a fifth as many twin trips.  Returns the trip's max |dx| over
    x, r and p, whether the trip's outputs are bit-equal, ms a trip, the
    twin's ms a trip, N and P."""
    import torch

    from pies_tpu_torch.ops.math3d import ieee_div
    from pies_tpu_torch.solver import assembly

    n = diag.shape[0]
    own = -(-n // assembly.CG_BLOCK)
    parts, at = world * own, (world - 1) * own
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, r, p, ap = (torch.randn((n, 3), device=dev, generator=gen) for _ in range(4))
    prz = torch.rand((2, parts), device=dev, generator=gen) + 0.5
    prz0, pap = (torch.rand(parts, device=dev, generator=gen) + 0.5 for _ in range(2))
    prr = torch.zeros(parts, device=dev)
    failed = torch.zeros(2, dtype=torch.int32, device=dev)
    trips = torch.zeros(1, dtype=torch.int32, device=dev)
    live = mask[:, None] > 0
    inv = ieee_div(torch.ones_like(diag), diag)[:, None]
    precond = lambda res: inv * res  # noqa: E731
    seen = {}

    def total(row):
        """This launch's r.z partials (kept in ``seen``) at its slice of
        ``row``, then the total over all R.P."""
        def at_slice(t):
            seen["rz"] = t
            return assembly.finalize(torch.cat([row[:at], t, row[at + own:]]))
        return at_slice

    xk, rk, pk, zk = x.clone(), r.clone(), p.clone(), torch.empty_like(x)
    assembly.cg_update(xk, pk, ap, rk, zk, diag, None, mask, prz, prz0, pap, prr, trips, failed,
                       0, 0, 0.0, at)
    assembly.cg_direction(pk, zk, prz, prz0, trips, failed, 0, 0, 0.0, at)
    xp, rp, pp, _, prr_p = assembly.cg_trip_plain(
        x, r, p, ap, assembly.finalize(prz[0]), assembly.finalize(pap), live, precond,
        total(prz[1]))
    torch.cuda.synchronize()
    equal = (torch.equal(xk, xp) and torch.equal(rk, rp) and torch.equal(pk, pp)
             and torch.equal(prz[1, at:], seen["rz"]) and torch.equal(prr[at:], prr_p)
             and int(trips[0]) == 1)
    err = max(float((a - b).abs().max()) for a, b in ((xk, xp), (rk, rp), (pk, pp)))
    state = {"i": 0}
    trips.zero_()

    def kernel_trip():
        i = state["i"]
        assembly.cg_update(xk, pk, ap, rk, zk, diag, None, mask, prz, prz0, pap, prr, trips,
                           failed, i, 0, 0.0, at)
        assembly.cg_direction(pk, zk, prz, prz0, trips, failed, i, 0, 0.0, at)
        state["i"] = i + 1

    plain = {"v": (x, r, p)}

    def plain_trip():
        xx, rr, pv = plain["v"]
        xx, rr, pv, _, _ = assembly.cg_trip_plain(
            xx, rr, pv, ap, assembly.finalize(prz[0]), assembly.finalize(pap), live, precond,
            total(prz[1]))
        plain["v"] = (xx, rr, pv)

    ms = cuda_ms(kernel_trip, reps)
    plain_ms = cuda_ms(plain_trip, max(reps // 5, 1))
    return dict(err=err, equal=equal, ms=ms, plain_ms=plain_ms, n=n, parts=parts, own=own)


def rank21(path):
    """Phase 21 on one rank (a spawned process, one of ``R21`` gloo ranks on
    the one card): the cases of the file ``path`` (``phase21`` writes it);
    returns this rank's results.  The kernels are the library the parent
    built: ``kernels.lib()`` only loads it."""
    import torch

    from pies_tpu_torch import kernels
    from pies_tpu_torch.parallel import domain, ensemble, halo, ranks
    from pies_tpu_torch.solver import assembly, pd
    from pies_tpu_torch.topology import to_device

    c = torch.load(path, weights_only=False)
    mesh = ranks.make_mesh()
    net = ranks.Transport(mesh)
    dev = mesh.device
    kernels.lib()
    wrappers = kernel_wrappers()

    def reset():
        for fns in wrappers.values():
            for f in fns:
                f.launches = 0

    def read():
        return {name: sum(f.launches for f in fns) for name, fns in wrappers.items()}

    def sync_time(fn, reps):
        """Host seconds per call of ``fn``, the stream synchronised around."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    def on_rank0(fn):
        """``fn()`` on rank 0 while the others wait (kernel timings alone on
        the card); None elsewhere."""
        out = fn() if mesh.rank == 0 else None
        torch.distributed.barrier()
        return out

    out = {"rank": mesh.rank}
    # 21a: the sharded ensemble.
    e = c["21a"]
    topo, params, cfg = to_device(e["topo"], dev), e["params"], e["config"]
    mine = ensemble.shard_ensemble(e["states"], mesh)
    step = ensemble.make_sharded_step(mesh, cfg)
    step(ensemble.shard_ensemble(e["states"], mesh), topo, params)  # (warm-up, a copy)
    reset()
    calls = step.transport.calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diag = [step(mine, topo, params)[1:] for _ in range(e["ticks"])]
    torch.cuda.synchronize()
    out["21a"] = dict(ms=(time.perf_counter() - t0) / e["ticks"] * 1e3, launches=read(),
                      diag=[(float(r), int(f)) for r, f in diag],
                      collectives=(step.transport.calls - calls) / e["ticks"])
    back = ensemble.gather_ensemble(mine, mesh)
    if mesh.rank == 0:
        out["21a"]["states"] = ensemble._map(torch.Tensor.cpu, back)
    del mine, back, topo

    # 21b: the domain over the ranks.
    for label in ("20a", "20b"):
        sc = c[label]
        params, cfg, n_live = sc["params"], sc["config"], sc["n_live"]
        t0 = time.perf_counter()
        dom = domain.partition_domain(sc["state"], sc["topo"], sc["slabs"],
                                      collision_margin=sc["margin"], mesh=mesh)
        meta = domain.local_meta(dom.meta, mesh)
        d, l, b, v = meta.n_slabs, meta.block, meta.halo, meta.view
        r = dict(partition_s=time.perf_counter() - t0, local=(d, l, b))
        # T30's outer-band modes against their twins at the scene's shapes.
        gen = torch.Generator(device=dev).manual_seed(21 + mesh.rank)
        own3 = torch.randn((d, l, 3), device=dev, generator=gen)
        own1 = own3[..., 0].contiguous()
        view3 = torch.randn((d, v, 3), device=dev, generator=gen)
        view4 = torch.rand((d, v, 4), device=dev, generator=gen) * 3
        p3 = torch.randn((d, l, 3), device=dev, generator=gen)
        same = {}
        for name, o in (("k=3", own3), ("k=1", own1)):
            bands = net.exchange(o[0, :b], o[-1, l - b:])
            same[f"refresh {name}"] = torch.equal(halo.refresh(o, b, False, *bands),
                                                  halo.refresh_plain(o, b, False, *bands))
        rb3 = net.exchange(view3[0, :b], view3[-1, v - b:])
        rb4 = net.exchange(view4[0, :b], view4[-1, v - b:])
        ref_bands = net.exchange(own3[0, :b], own3[-1, l - b:])
        same["reduce k=3"] = torch.equal(halo.reduce(view3, b, left=rb3[0], right=rb3[1]),
                                         halo.reduce_plain(view3, b, left=rb3[0], right=rb3[1]))
        yk, pk = halo.reduce(view3, b, p=p3, left=rb3[0], right=rb3[1])
        yp, pp = halo.reduce_plain(view3, b, p=p3, left=rb3[0], right=rb3[1])
        same["reduce p.Ap"] = torch.equal(yk, yp) and torch.equal(pk, pp)
        same["average"] = torch.equal(
            halo.reduce(view4, b, halo.AVERAGE, left=rb4[0], right=rb4[1]),
            halo.reduce_plain(view4, b, halo.AVERAGE, left=rb4[0], right=rb4[1]))
        xa, pa = own3.clone(), p3.clone()
        xb, pb = own3.clone(), p3.clone()
        act = (torch.rand((d, l), device=dev, generator=gen) < 0.1).float()
        ok_failed = torch.zeros(2, dtype=torch.int32, device=dev)
        for xx, pv, fn in ((xa, pa, halo.reduce), (xb, pb, halo.reduce_plain)):
            fn(view4, b, halo.APPLY, x_own=xx, prev_own=pv, active=act, stat=view3[:, b:b + l]
               .contiguous(), failed=ok_failed, left=rb4[0], right=rb4[1])
        same["apply"] = torch.equal(xa, xb) and torch.equal(pa, pb)
        torch.cuda.synchronize()
        r["bands_equal"] = same
        # The operator across the ranks on the parent's seeded vector.
        mine = slice(mesh.rank * d * l, (mesh.rank + 1) * d * l)
        p_own = sc["p_own"][mine].to(dev)
        own_parts = -(-d * l // 256)
        buf = torch.empty(mesh.world * own_parts, device=dev)
        y, _ = domain.operator(dom, params, mesh=mesh)(
            p_own, buf[mesh.rank * own_parts:(mesh.rank + 1) * own_parts])
        net.gather_(buf, own_parts)
        r["operator"] = (y.cpu(), float(buf.double().sum()))
        # One tick, and a rerun of it from the same partition.
        tick = domain.make_domain_tick(cfg, dom.meta, mesh=mesh)
        start = [getattr(dom.state, f).clone() for f in domain_fields()]
        tick(dom.state, dom.static, params)
        r["one_tick"] = domain.gather_positions(dom, dom.state, mesh)[:n_live]
        again = domain.shard_host(dom.host, dom.meta, mesh)
        if not all(torch.equal(a, getattr(again.state, f))
                   for a, f in zip(start, domain_fields())):
            raise RuntimeError(f"21b {label}: the rerun's start differs")
        tick(again.state, again.static, params)
        r["rerun_equal"] = all(torch.equal(getattr(again.state, f), getattr(dom.state, f))
                               for f in domain_fields())
        del again
        # Three timed 10-tick windows.
        r["ms"], r["counts"] = [], []
        for w in range(3):
            counters = pd.new_counters(dev)
            reset()
            calls = tick.transport.calls
            r["ms"].append(sync_time(lambda: tick(dom.state, dom.static, params, counters), 10)
                           * 1e3)
            r["launches"] = read()
            r["collectives"] = (tick.transport.calls - calls) / 10
            r["counts"].append(domain.read_counters(counters, mesh))
        r["ok"] = (not bool(dom.state.sim_failed.any())
                   and bool(torch.isfinite(dom.state.positions).all()))
        # Timings at this scene's shapes: T30's band modes alone on the card,
        # the exchange and the gather (every rank takes part), and the CG
        # across the ranks (kernels, then twins) on the seeded vector.
        lb, rb = ref_bands
        r["t30"] = on_rank0(lambda: dict(
            refresh=cuda_ms(lambda: halo.refresh(own3, b, False, lb, rb), 50),
            refresh_plain=cuda_ms(lambda: halo.refresh_plain(own3, b, False, lb, rb), 10),
            reduce=cuda_ms(lambda: halo.reduce(view3, b, left=rb3[0], right=rb3[1]), 50),
            reduce_plain=cuda_ms(lambda: halo.reduce_plain(view3, b, left=rb3[0],
                                                           right=rb3[1]), 10)))
        r["exchange_ms"] = sync_time(lambda: net.exchange(own3[0, :b], own3[-1, l - b:]), 50) * 1e3
        r["gather_ms"] = sync_time(lambda: net.gather_(buf, own_parts), 50) * 1e3
        h2 = pd._h_h2(params)[1]
        so = dom.static.own
        diag = so.mass / h2 + so.stiffness_diag
        failed = torch.zeros(2, dtype=torch.int32, device=dev)
        cg = lambda plain: (assembly.pcg_solve_plain if plain else assembly.pcg_solve)(  # noqa: E731
            p_own, torch.zeros_like(p_own), diag, None, None, h2, so.node_mask, None,
            cfg.cg_iterations, cfg.cg_rtol, failed,
            matvec=domain.operator(dom, params, plain=plain, mesh=mesh), ranks=net)
        xk, rk, tk = cg(False)
        xp, rp, tp = cg(True)
        torch.cuda.synchronize()
        r["cg_equal"] = torch.equal(xk, xp) and torch.equal(rk, rp) and torch.equal(tk, tp)
        r["cg_trips"] = int(tk[0])
        r["cg_ms"] = sync_time(lambda: cg(False), 3) * 1e3
        r["cg_plain_ms"] = sync_time(lambda: cg(True), 1) * 1e3
        r["t11"] = on_rank0(lambda: hold_t11(diag, so.node_mask, mesh.world, dev, 11))
        if label == "20a":
            # 21c: a NaN in one rank's slab latches every rank on that substep;
            # the next tick leaves every rank's state bit for bit.
            if mesh.rank == NAN_RANK:
                node = int((so.node_mask.view(d, l)[0] > 0).nonzero()[0, 0])
                dom.state.positions[0, node, 0] = float("nan")
            before = bool(dom.state.sim_failed.any())
            tick(dom.state, dom.static, params)
            words = dom.state.sim_failed.tolist()
            bits = [getattr(dom.state, f).view(torch.int32).clone()
                    for f in ("positions", "prev_positions", "velocities")]
            tick(dom.state, dom.static, params)
            frozen = all(torch.equal(a, getattr(dom.state, f).view(torch.int32))
                         for a, f in zip(bits, ("positions", "prev_positions", "velocities")))
            r["latch"] = dict(before=before, words=words, frozen=frozen)
        out[label] = r
        del dom, tick
        torch.cuda.empty_cache()
    return out


def domain_fields():
    return ("positions", "prev_positions", "velocities", "shape_quats", "sim_failed")


def phase21(pt, dev, smi, row, rows, ens13, keep21, ticks=10, backend="gloo"):
    """Phase 21: the domain decomposition and the ensembles across
    ``torch.distributed`` ranks (ROADMAP item 11b), ``R21`` gloo ranks on
    the one card (NCCL refuses two ranks on one device; gloo stages the
    bands through the host, ``parallel/ranks.py``), started once
    (``ranks.launch``) after the parent built the kernels:

    21a phase 13's ensemble (64 x the 512-tet soup with self-contact) from
    its last tick, 16 members a rank, ``ticks`` sharded steps: every
    member bit-equal to the one-process ensemble's, the fleet's residual
    and latched count equal on every tick; ms/tick per rank, launches per
    tick.  21b phase 20a's mesh in 8 slabs (two a rank) and phase 20b's
    soup with self-contact in 4 (every halo across ranks): T30's
    outer-band modes bit-equal to their twins at the rank's shapes; the
    operator across the ranks (refresh, T10, reduce) on one seeded vector
    bit-equal to phase 20's one-card operator, its p.Ap total within 1e-5
    of the float64 dot; one tick within the bound phase 20 held the slabs
    to, against the single scene's tick; a rerun bit-identical on every
    rank; three timed 10-tick windows beside phase 20's one-card ms/tick;
    the CG across the ranks by the kernels bit-equal to the twins'.  21c
    a NaN in one rank's slab latches every rank on that substep.
    ``backend="nccl"`` runs the same ranks one a card
    (``scripts/ranks_nccl.py``)."""
    import tempfile

    import numpy as np
    import torch

    from pies_tpu_torch.parallel import domain, ensemble, ranks

    t_phase = time.perf_counter()
    states, topo13, params13, cfg13 = ens13
    members = states.members
    one = clone_state(states)
    diag = [tuple(ensemble.ensemble_step(one, topo13, params13, cfg13)) for _ in range(ticks)]
    diag = [(float(r), int(f)) for r, f in diag]
    to_cpu = lambda obj: ensemble._map(torch.Tensor.cpu, obj)  # noqa: E731
    cases = {"21a": dict(states=to_cpu(states), topo=to_cpu(topo13),
                         params=params13, config=cfg13, ticks=ticks)}
    ops_one = {}
    for label, k in keep21.items():
        dom1 = k["dom"]
        meta = dom1.meta
        gen = torch.Generator(device=dev).manual_seed(21)
        p_own = (torch.randn((meta.n_slabs * meta.block, 3), device=dev, generator=gen)
                 * dom1.static.own.node_mask[:, None])
        y1, _ = domain.operator(dom1, k["params"])(p_own)
        ops_one[label] = (y1.cpu(), float((p_own.double() * y1.double()).sum()))
        cases[label] = dict(state=to_cpu(k["state"]), topo=to_cpu(k["topo"]),
                            params=k["params"], config=k["config"], n_live=k["n_live"],
                            slabs=meta.n_slabs, margin=k["margin"], p_own=p_own.cpu())
    where = "the one card" if backend == "gloo" else f"{R21} cards"
    print(f"phase 21: {R21} {backend} ranks on {where}: 21a {members} x the 512-tet soup"
          f" ({members // R21} a rank), 21b "
          + ", ".join(f"{lab}: {c['slabs']} slabs" for lab, c in cases.items() if lab != "21a"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cases.pt")
        torch.save(cases, path)
        t0 = time.perf_counter()
        res = ranks.launch(rank21, R21, backend, path, store_dir=tmp)
        print(f"  ({R21} ranks ran in {time.perf_counter() - t0:.1f} s, their start included)")
    del cases

    # 21a
    got = res[0]["21a"]["states"]
    fields = ("positions", "prev_positions", "velocities", "forces", "sim_failed")
    apart = [b for b in range(members)
             if not all(torch.equal(getattr(got, f)[b].to(dev), getattr(one, f)[b])
                        for f in fields)
             or not all(torch.equal(getattr(got.bp, f)[b].to(dev), getattr(one.bp, f)[b])
                        for f in ("pairs", "valid", "ref", "fresh"))]
    check(not apart, f"21a: all {members} members after {ticks} sharded steps over {R21} ranks"
          f" bit-equal to the one-process ensemble's, caches too (apart: {apart})")
    check(all(r["21a"]["diag"] == diag for r in res),
          f"21a: the fleet's largest residual and latched count equal the one-process"
          f" ensemble_step's on every tick, on every rank (last {diag[-1]})")
    per_tick = [sum(r["21a"]["launches"].values()) / ticks for r in res]
    print("  21a: " + ", ".join(f"rank {r['rank']} {r['21a']['ms']:.3f} ms/tick" for r in res)
          + f" ({smi}); launches per tick {per_tick}, collectives"
          f" {res[0]['21a']['collectives']:.1f}")

    # 21b
    cells = {}
    for label, k in keep21.items():
        rs = [r[label] for r in res]
        d, l, b = rs[0]["local"]
        check(all(all(r["bands_equal"].values()) for r in rs),
              f"21b {label}: T30's outer-band modes (refresh k=1, 3; reduce; p.Ap; average;"
              f" apply) bit-equal to their twins on every rank at D = {d}, L = {l}, B = {b}")
        y1, dot1 = ops_one[label]
        y = torch.cat([r["operator"][0] for r in rs])
        total = rs[0]["operator"][1]
        check(torch.equal(y, y1) and all(r["operator"][1] == total for r in rs)
              and abs(total - dot1) <= 1e-5 * abs(dot1),
              f"21b {label}: the operator across {R21} ranks (refresh, T10, reduce with the"
              f" bands) on one seeded vector bit-equal to phase 20's one-card operator; its"
              f" p.Ap total {total:.9e}, the same on every rank, within 1e-5 of the float64"
              f" dot {dot1:.9e}")
        pos = torch.from_numpy(rs[0]["one_tick"])
        err = float((pos - k["single"]).abs().max())
        err1 = float((pos - k["one_card"]).abs().max())
        check(all(np.array_equal(r["one_tick"], rs[0]["one_tick"]) for r in rs)
              and err <= k["tol"] and err1 <= 1e-5,
              f"21b {label}: one tick over {R21} ranks within {k['tol']:.3e} (phase 20's bound)"
              f" of the single scene's tick (max |dx| {err:.3e}) and within 1e-5 of phase 20's"
              f" one-card domain tick ({err1:.3e})")
        check(all(r["rerun_equal"] for r in rs),
              f"21b {label}: a rerun of the tick from the same partition bit-identical on every"
              " rank")
        check(all(r["cg_equal"] for r in rs),
              f"21b {label}: the CG across the ranks by the kernels (T11's split partials, T10,"
              f" T30) bit-equal to the twins' ({rs[0]['cg_trips']} trips; a solve"
              f" {rs[0]['cg_ms']:.3f} ms on the host's clock, collectives included)")
        t11 = rs[0]["t11"]
        t11_nbytes = 128 * t11["n"] + 4 * (3 * t11["parts"] + 2 * t11["own"])
        t11_ops = 32 * t11["n"] + 4 * t11["parts"]
        check(t11["equal"],
              f"21b {label}: T11's update and direction over N = {t11['n']} with their partials"
              f" at the last rank's slice of {t11['parts']} bit-equal to their twin"
              f" (assembly.cg_trip_plain); {t11['ms']:.4f} ms a trip against a bound of"
              f" {bound(t11_nbytes, t11_ops)[0]:.4f} ms, the twin {t11['plain_ms']:.4f} ms")
        counts = rs[0]["counts"][-1]
        check(all(r["ok"] for r in rs) and counts["cg_trips"] > 0
              and (label != "20b" or counts["contacts"] > 0),
              f"21b {label}: no rank latched, finite after the windows; counters summed over"
              f" the ranks {dict((n, v) for n, v in counts.items() if v)}")
        launches = rs[0]["launches"]
        names = ["halo_refresh", "halo_reduce", "pcg", "ell_matvec", "substep_head",
                 "substep_tail"]
        check(all(launches[n] > 0 for n in names),
              f"21b {label}: every kernel of the path launched on rank 0: "
              + ", ".join(f"{n} {launches[n] / 10:.1f}/tick" for n in names))
        ms = [min(r["ms"]) for r in rs]
        print(f"  21b {label}: {d} slabs a rank; windows "
              + "; ".join(f"rank {i} " + ", ".join(f"{m:.3f}" for m in r["ms"])
                          for i, r in enumerate(rs))
              + f" ms/tick; phase 20's one card {k['ms']:.3f} ms/tick ({smi});"
              f" {sum(launches.values()) / 10:.1f} launches and {rs[0]['collectives']:.1f}"
              f" collectives per tick on rank 0; exchange"
              f" {rs[0]['exchange_ms']:.3f} ms, gather {rs[0]['gather_ms']:.3f} ms a call;"
              f" partition {max(r['partition_s'] for r in rs):.2f} s")
        cells[label] = dict(slabs_per_rank=d, ranks=R21, ms_per_tick=ms,
                            one_card_ms_per_tick=k["ms"], launches_per_tick=sum(
                                launches.values()) / 10, collectives_per_tick=rs[0]["collectives"],
                            exchange_ms=rs[0]["exchange_ms"],
                            gather_ms=rs[0]["gather_ms"], one_tick_dx=err, one_card_dx=err1,
                            cg_trips=rs[0]["cg_trips"], cg_solve_ms=rs[0]["cg_ms"],
                            cg_solve_plain_ms=rs[0]["cg_plain_ms"], t11_trip_ms=t11["ms"],
                            t11_trip_plain_ms=t11["plain_ms"])
        if label == "20a":
            lat = [r["latch"] for r in rs]
            check(all(not x["before"] and x["words"] == lat[0]["words"] and x["words"][1] == 1
                      and x["frozen"] for x in lat),
                  f"21c: a NaN in rank {NAN_RANK}'s slab latched every rank on that substep"
                  f" (latch words {[x['words'] for x in lat]}); the next tick left every rank's"
                  " state bit for bit")
            # The kernel table's rows of the slice's new modes, at 20a's shapes.
            t30, v = rs[0]["t30"], l + 2 * b
            n, nv, trips = d * l, d * v, rs[0]["cg_trips"]
            rb = 4 * (n * 3 + 2 * b * 3 + nv * 3)
            row("halo_refresh (outer bands)", "pies_tpu_torch/kernels/csrc/halo.cu",
                "pies_tpu/parallel/domain.py:581", 0.0, t30["refresh"], t30["refresh_plain"],
                "equal", rb, 0)
            row("halo_reduce (outer bands)", "pies_tpu_torch/kernels/csrc/halo.cu",
                "pies_tpu/parallel/domain.py:596", 0.0, t30["reduce"], t30["reduce_plain"],
                "equal", rb, 3 * n)
            # T11's row: one trip of its update and direction over R.P
            # partials; the whole solve across the ranks, collectives
            # included, beside it as a transport figure.
            row("pcg (ranks)", "pies_tpu_torch/kernels/csrc/pcg.cu",
                "pies_tpu/parallel/domain.py:612", t11["err"], t11["ms"], t11["plain_ms"],
                "equal", t11_nbytes, t11_ops)
            rows["pcg (ranks)"].update(solve_ms=rs[0]["cg_ms"], solve_plain_ms=rs[0]["cg_plain_ms"],
                                       solve_trips=trips)
            for name, key in zip(RANK_ROWS, ("halo_refresh", "halo_reduce", "pcg")):
                rows[name]["launches"] = launches[key]
                rows[name]["launches_by_rank"] = [r["launches"][key] for r in rs]
                rows[name]["exchange_ms"] = rs[0]["exchange_ms"]
                rows[name]["gather_ms"] = rs[0]["gather_ms"]
    rows["pcg (ranks)"]["domain_ranks_cells"] = cells
    print(f"  (phase 21: {time.perf_counter() - t_phase:.1f} s)")


def main(n_tets=N_TETS, n_small=4096, dev=None, mesh_big=MESH_BIG, mesh_warmup=MESH_WARMUP,
         cloth_n=CLOTH_N, n_blobs=N_BLOBS, mixed_sheet=MIXED_SHEET, small_sheet=SMALL_SHEET,
         pbd_big=PBD_BIG, pbd_bench=PBD_BENCH, nets_nn=NETS_NN, nets_big=NETS_BIG,
         cloud_n=CLOUD_N, ens_members=ENS_MEMBERS, ens_tets=ENS_TETS, ens_small=ENS_SMALL,
         mesh_res=MESH_RES, mesh_scale=MESH_SCALE, mesh_dump=MESH_BIG, ens_drop=ENS_DROP,
         ens_rope=ENS_ROPE, drop_res=DROP_RES, ens_cloth=ENS_CLOTH, ens_block=ENS_BLOCK,
         ens_contacts=ENS_DROP, ens_pile=ENS_PILE, contact_res=DROP_RES, pile_boxes=5,
         ens_nets=ENS_NETS, ens_cloud=ENS_CLOUD, ens_big=ENS_BIG, ens_pbd=ENS_PBD,
         domain_small=16_384, domain_slabs=(3, 8)):
    import torch

    # ---- phase 0
    print("phase 0: the card")
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs only on a GPU", file=sys.stderr)
        return 2
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}"
          f" device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    try:
        import triton  # noqa: F401

        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")

    import numpy as np

    import pies_tpu_torch as pt
    from pies_tpu_torch import diagnostics, kernels
    from pies_tpu_torch.collision import broadphase
    from pies_tpu_torch.collision.batches import CollisionSet, incident
    from pies_tpu_torch.constraints import projections as proj
    from pies_tpu_torch.parallel import halo
    from pies_tpu_torch.solver import assembly, pbd, pd, step, tetcols
    from pies_tpu_torch.tick_profile import device_events
    from torch.profiler import ProfilerActivity, profile

    print("nvcc: " + run([kernels._nvcc(), "--version"]).splitlines()[-1])
    dev = dev or torch.device("cuda", 0)
    PD = pt.SolverName.PD
    soup_tets = n_tets  # (later phases reuse the name for their own tet counts)

    t_main = [time.perf_counter()] * 2

    def stamp(phase):
        """Each phase's seconds, and the script's so far."""
        now = time.perf_counter()
        print(f"  (phase {phase}: {now - t_main[1]:.1f} s; {now - t_main[0]:.1f} s since the"
              " start)")
        t_main[1] = now

    # ---- phase 1
    print("phase 1: build")
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.lib()
    print(f"build + load {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds} s)")
    print("\n".join(l for l in kernels.build_log.splitlines() if "registers" in l or "spill" in l
                    or "Compiling entry" in l or l.startswith("==")))

    rows = {}
    keep = {}  # solvers of earlier phases that phase 14 reads
    domain_keep = {}  # the states phase 20 starts from

    def row(name, source, replaces, err, ms, plain_ms, tol_text, nbytes, ops, library_ms=None):
        b_ms, b_by = bound(nbytes, ops)
        lib_text = "" if library_ms is None else f", library {library_ms:.4f} ms"
        print(f"  {name}: max err {err:.3e} ({tol_text}); kernel {ms:.4f} ms, plain {plain_ms:.4f}"
              f" ms{lib_text}, bound {b_ms:.4f} ms ({b_by})")
        rows[name] = dict(name=name, route="cuda", source=source, replaces=replaces,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=library_ms)

    def index_add_ms(inc, rows, n):
        """The library's yardstick for a per-node sum of ``rows`` over an
        incidence (T9 stage 2): one ``index_add_`` of the rows into their
        nodes (atomics, in no fixed order)."""
        live = int(inc.row_start[-1])
        node = torch.zeros(rows.shape[0], dtype=torch.long, device=dev)
        node[inc.entries[:live].long()] = inc.nodes[:live].long()
        return cuda_ms(lambda: torch.zeros((n, rows.shape[1]), device=dev).index_add_(0, node,
                                                                                       rows), 20)

    def contact_set(contacts):
        idx, _, count = contacts
        return {tuple(r) for r in idx[: int(count[0])].tolist()}

    def hold_tri(mode, x, prev, tris, tmask, params, cfg, failed, ref_contacts, ref_name,
                 relation="equals"):
        """T16 then T17 in the per-triangle branch ``mode`` against their
        twins: candidate rows, counts, flag words, latch and contact list
        equal, no latch; the contact set equal to ``ref_contacts``' (kernels
        ``ref_name`` on the same state; the per-triangle sweep repeats a
        contact once per own face that finds it, so lists differ and sets do
        not), or, by ``relation``, one that "contains" it or lies "within"
        it.  Returns the layout, the
        scalars, the twin's work counts, the kernel's candidate rows and its
        contacts."""
        lay = broadphase.tri_layout(cfg, tris.shape[0], mode)
        sc = broadphase.tri_scalars(params, cfg)
        out, stats = [], {}
        for cf, df, kw in ((broadphase.tri_candidates, broadphase.tri_ccd, {}),
                           (broadphase.tri_candidates_plain, broadphase.tri_ccd_plain,
                            dict(stats=stats))):
            ov = torch.zeros(1, dtype=torch.int32, device=dev)
            cand, count, flags = cf(x, prev, tris, tmask, lay, sc, ov, failed)
            contacts = df(x, prev, tris, cand, count, flags, lay, sc, failed, **kw)
            out.append((cand, count, flags, ov, contacts))
        torch.cuda.synchronize()
        (ck, nk, fk, ok, pk), (cp, np_, fp, op, pp) = out
        named = dict(zip(broadphase.TRI_FLAGS, fk.tolist()))
        check(torch.equal(ck, cp) and torch.equal(nk, np_) and torch.equal(fk, fp)
              and torch.equal(ok, op),
              f"T16 {mode} at {lay.t} rows, {lay.nb} slots: candidate rows, counts, flags and"
              f" latch equal (flags {named}, most per row {int(nk.max())})")
        check(all(torch.equal(a, b) for a, b in zip(pk, pp)),
              f"T17 {mode} at {lay.lanes} lanes: contacts equal ({int(pk[2][0])} of at most"
              f" {lay.cap}, {stats})")
        mine, ref = contact_set(pk), contact_set(ref_contacts)
        same = {"equals": mine == ref, "contains": ref <= mine, "within": mine <= ref}[relation]
        check(same and len(mine) > 0 and int(ok[0]) == 0 and int(pk[2][0]) < lay.cap,
              f"T16/T17 {mode}: no latch, the contact set {relation}"
              f" {ref_name}'s ({len(mine)} distinct of {int(pk[2][0])} contacts, {len(ref)}"
              f" there; only here {sorted(mine - ref)[:4]}, only there {sorted(ref - mine)[:4]})")
        return lay, sc, stats, (ck, nk, fk), pk

    def time_tri(mode, x, prev, tris, tmask, failed, held, n_nodes):
        """CUDA-event times of T16 and T17 (and their twins) on the state
        ``hold_tri`` held, with their bounds; printed, and returned as
        ``(ms16, plain16, bytes16, ops16, ms17, plain17, bytes17, ops17)``."""
        lay, sc, stats, (cand, count, flags), pk = held
        c16 = lambda fn: fn(x, prev, tris, tmask, lay, sc, zero(), failed)  # noqa: E731
        c17 = lambda fn: fn(x, prev, tris, cand, count, flags, lay, sc, failed)  # noqa: E731
        ms16, ms16p = (cuda_ms(lambda: c16(broadphase.tri_candidates), 10),
                       cuda_ms(lambda: c16(broadphase.tri_candidates_plain), 2))
        ms17, ms17p = (cuda_ms(lambda: c17(broadphase.tri_ccd), 10),
                       cuda_ms(lambda: c17(broadphase.tri_ccd_plain), 2))
        # T16: positions at both times, the triangles and their mask read once,
        # the candidate rows and counts written; all-pairs compares every
        # pair's boxes (6 float comparisons), a grid branch every gathered
        # candidate's (at most raw per row, per body row in the per-body one).
        bytes16 = 24 * n_nodes + 16 * lay.t + 4 * lay.t * (lay.nb + 1)
        ops16 = 6 * (lay.t * lay.t if mode == "allpairs" else lay.k * lay.raw)
        # T17: the rows, counts, positions and triangles read once, the
        # contacts written; ~200 float operations per corner test of a live
        # lane.
        bytes17 = 4 * lay.t * (lay.nb + 1) + 24 * n_nodes + 12 * lay.t + 20 * lay.cap
        ops17 = 3 * 200 * stats["live_lanes"]
        b16, b17 = bound(bytes16, ops16), bound(bytes17, ops17)
        print(f"  {mode}: T16 {ms16:.4f} ms (plain {ms16p:.4f}, bound {b16[0]:.4f} ms, {b16[1]}),"
              f" T17 {ms17:.4f} ms (plain {ms17p:.4f}, bound {b17[0]:.4f} ms, {b17[1]});"
              f" {lay.t} rows, {lay.lanes} lanes, {stats['live_lanes']} live, {int(pk[2][0])}"
              f" contacts ({smi})")
        return ms16, ms16p, bytes16, ops16, ms17, ms17p, bytes17, ops17

    stamp("1")

    # ---- phase 2
    print(f"phase 2: T1-T4 against twins at {n_tets} tets, {4 * n_tets} nodes")
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=False, device=dev)
    s.create_tet_soup(n_tets, **SCENE)
    t0 = time.perf_counter()
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    print(f"scene set-up {time.perf_counter() - t0:.2f} s, capacity {st.capacity}")
    n_nodes, n_cols = st.capacity, topo.strain.qinv.shape[1]
    # Seeded velocities with a downward drift, so the predicted positions of
    # the bottom layer fall below the floor threshold.
    rng = np.random.default_rng(0)
    vel = 0.5 * rng.standard_normal((st.capacity, 3)) + np.array([0.0, -40.0, 0.0])
    st.velocities.copy_(torch.from_numpy(vel.astype(np.float32)).to(dev) * st.node_mask[:, None])
    plane = 0.0

    sk, sp = clone_state(st), clone_state(st)
    hk = pd.substep_head(sk, topo, params, cfg, True)
    hp = pd.substep_head_plain(sp, topo, params, cfg, True)
    torch.cuda.synchronize()
    ulps = max(max_ulp(a, b) for a, b in zip(hk, hp))
    err = max(float((a - b).abs().max()) for a, b in zip(hk, hp))
    check(ulps <= 1.0, f"T3 substep_head within 1 ulp (max {ulps} ulp)")
    check(float(hk[4].sum()) > 0, f"T3 floor-active nodes: {int(hk[4].sum())}")
    row("substep_head", "pies_tpu_torch/kernels/csrc/substep_ends.cu", "pies_tpu/solver/pd.py:59",
        err, cuda_ms(lambda: pd.substep_head(sk, topo, params, cfg, False), 50),
        cuda_ms(lambda: pd.substep_head_plain(sp, topo, params, cfg, False), 20), f"{ulps} ulp",
        76 * n_nodes, 17 * n_nodes)

    x, msn, diag, wf, active = hk
    fk = proj.tet_force12(x, topo.strain, topo.volume, st.sim_failed)
    fp = proj.tet_force12_plain(x, topo.strain, topo.volume)
    torch.cuda.synchronize()
    scale = float(fp.abs().max())
    err = float((fk - fp).abs().max())
    check(err <= 1e-4 * scale, f"T1 tet_force12 within 1e-4 of max |f| = {scale:.1f}")
    row("tet_force12", "pies_tpu_torch/kernels/csrc/tet_force.cu",
        "pies_tpu/constraints/projections.py:311", err,
        cuda_ms(lambda: proj.tet_force12(x, topo.strain, topo.volume, st.sim_failed), 20),
        cuda_ms(lambda: proj.tet_force12_plain(x, topo.strain, topo.volume), 5),
        f"rel {err / scale:.2e}", 204 * n_cols, 1500 * n_cols)
    rows["tet_force12"]["form"] = ("the standalone launch, T1's parity check: on every path T2"
                                   " computes the first iteration's force itself (0 launches)")

    args = (x, msn, diag, st.node_mask, wf, topo, plane, cfg.iterations, st.sim_failed)
    ck = tetcols.substep_cols(*args)
    cp = tetcols.substep_cols_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(ck[:2], cp[:2]))
    r2err = float((ck[2] - cp[2]).abs().max())
    check(err <= 1e-4, "T2 tet_cols_substep x and static projection within 1e-4")
    print(f"  T2 residual: kernel {float(ck[2].sum().sqrt()):.6g}, plain"
          f" {float(cp[2].sum().sqrt()):.6g}, per-tet max diff {r2err:.3e}")
    row("tet_cols_substep", "pies_tpu_torch/kernels/csrc/tet_cols_substep.cu",
        "pies_tpu/solver/tetcols.py:263", err,
        cuda_ms(lambda: tetcols.substep_cols(*args), 20),
        cuda_ms(lambda: tetcols.substep_cols_plain(*args), 3), "abs",
        424 * (n_nodes // 4), 1600 * cfg.iterations * (n_nodes // 4))

    x_new, static_proj, _ = ck
    tk, tp = clone_state(st), clone_state(st)
    pd.substep_tail(tk, topo, params, active, x_new, static_proj)
    pd.substep_tail_plain(tp, topo, params, active, x_new, static_proj)
    torch.cuda.synchronize()
    fields = ("positions", "prev_positions", "velocities", "forces", "sim_failed")
    ulps = max(max_ulp(getattr(tk, f), getattr(tp, f)) for f in fields[:4])
    err = max(float((getattr(tk, f) - getattr(tp, f)).abs().max()) for f in fields[:4])
    check(ulps <= 1.0 and torch.equal(tk.sim_failed, tp.sim_failed),
          f"T4 substep_tail within 1 ulp (max {ulps} ulp), same latch")
    row("substep_tail", "pies_tpu_torch/kernels/csrc/substep_ends.cu", "pies_tpu/solver/pd.py:316",
        err, cuda_ms(lambda: pd.substep_tail(tk, topo, params, active, x_new, static_proj), 50),
        cuda_ms(lambda: pd.substep_tail_plain(tp, topo, params, active, x_new, static_proj), 20),
        f"{ulps} ulp", 120 * n_nodes, 25 * n_nodes)
    del s, st, sk, sp, tk, tp, hk, hp, fk, fp, ck, cp, args

    stamp("2")

    # ---- phase 2b
    print(f"phase 2b: T5-T8 against twins at {n_tets} tets, contact-active state")
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, device=dev)
    s.create_tet_soup(n_tets, **SCENE)
    t0 = time.perf_counter()
    s.run_ticks(CONTACT_WARMUP)
    print(f"{CONTACT_WARMUP} ticks of the kernels: {time.perf_counter() - t0:.2f} s")
    check(not s.sim_failed, "no sim_failed after the warm-up")
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    lay = broadphase.body_layout(cfg, topo.tri_mask.shape[0])
    sc = broadphase.scalars(params)
    failed = st.sim_failed
    x, msn, diag, wf, active = pd.substep_head_plain(clone_state(st), topo, params, cfg, True)
    prev, tmask = st.prev_positions, topo.tri_mask
    zero = lambda: torch.zeros(1, dtype=torch.int32, device=dev)  # noqa: E731
    cache_fields = ("pairs", "valid", "ref", "fresh")

    def t5(fn, force):
        c, ov = st.bp.clone(), zero()
        if force:
            c.fresh.zero_()
        rb = fn(x, prev, tmask, c, lay, sc, ov, failed)
        return c, ov, rb

    for force in (False, True):
        (c5k, ov5k, rbk), (c5p, ov5p, rbp) = (t5(broadphase.body_broadphase, force),
                                              t5(broadphase.body_broadphase_plain, force))
        torch.cuda.synchronize()
        same = (all(torch.equal(getattr(c5k, f), getattr(c5p, f)) for f in cache_fields)
                and torch.equal(ov5k, ov5p) and int(rbk[0]) == int(rbp[0]))
        check(same, f"T5 body_broadphase cache and flags equal (rebuild forced {force},"
                    f" rebuilt {int(rbk[0])}, valid pairs {int(c5k.valid.sum())},"
                    f" overflow {int(ov5k[0])})")
    cache = c5k
    timing_cache, ov = st.bp.clone(), zero()

    def rebuild(fn):
        timing_cache.fresh.zero_()
        fn(x, prev, tmask, timing_cache, lay, sc, ov, failed)

    n_body_nodes = lay.k * lay.m
    # (a rebuild: x, prev and ref read, ref and the cache rows written, the
    # mask read; without one only the reads of x, prev, ref and the mask)
    row("body_broadphase", "pies_tpu_torch/kernels/csrc/body_broadphase.cu",
        "pies_tpu/collision/broadphase.py:210", 0.0,
        cuda_ms(lambda: rebuild(broadphase.body_broadphase), 20),
        cuda_ms(lambda: rebuild(broadphase.body_broadphase_plain), 3), "equal",
        48 * n_body_nodes + 4 * lay.k * lay.e + 8 * lay.lanes + 4, 1000 * lay.k)
    found_cache = st.bp.clone()
    rows["body_broadphase"].update(
        form="with a rebuild forced (the fill that forces it included)",
        found_ms=cuda_ms(lambda: broadphase.body_broadphase(x, prev, tmask, found_cache, lay, sc,
                                                            ov, failed), 20),
        found_bound_ms=bound(36 * n_body_nodes + 4 * lay.k * lay.e, 40 * n_body_nodes)[0])

    def t6(fn, xx, **kw):
        ovx = zero()
        out = fn(xx, prev, tmask, cache, lay, sc, ovx, failed, **kw)
        return out, ovx

    rng = np.random.default_rng(1)
    jitter = torch.from_numpy((0.05 * rng.standard_normal(x.shape)).astype(np.float32)).to(dev)
    x_cross = x + jitter * st.node_mask[:, None]
    stats = {}
    for name, xx in (("as found", x), ("jittered", x_cross)):
        stats[name] = {}
        (pk, ovk), (pp, ovp) = t6(broadphase.pt_narrowphase, xx), \
            t6(broadphase.pt_narrowphase_plain, xx, stats=stats[name])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(pk, pp)) and torch.equal(ovk, ovp)
        check(same, f"T6 pt_narrowphase contacts equal ({name}: {int(pk[2][0])} contacts,"
                    f" {stats[name]})")
    check(stats["jittered"]["cross_combos"] > 0,
          f"T6 phase 2 ran: {stats['jittered']['cross_combos']} crossing combos")
    pk, _ = t6(broadphase.pt_narrowphase, x)
    n_contacts = int(pk[2][0])
    check(n_contacts > 0, f"contacts in the state: {n_contacts}")
    print("phase 9b (on this state): T16 and T17 in the per-body branch, the packed node"
          " layout switched off")
    cap_b = 4 * cfg.budget.max_point_tri_contacts  # room for the per-face repetition
    cfg_b = dataclasses.replace(cfg, body_nodes=0, body_node_offset=0, body_faces=(),
                                budget=dataclasses.replace(cfg.budget,
                                                           max_point_tri_contacts=cap_b))
    # The reference: T5 and T6 on a fresh cache with zero slack (the cached
    # pairs' slack tier may be evicted from a full row without a latch).
    fresh = broadphase.detect_point_tri_collisions(x, prev, tmask, params, cfg, failed=failed,
                                                   triangles=topo.triangles)[:3]
    held = hold_tri("bodies", x, prev, topo.triangles, tmask, params, cfg_b, failed, fresh,
                    "T5 and T6 (fresh)")
    time_tri("bodies", x, prev, topo.triangles, tmask, failed, held, st.capacity)
    # (phase 16c's per-body branch on this state, on the generic path)
    keep.setdefault("9b", {})["soup"] = (clone_state(st), topo, params,
                                        dataclasses.replace(cfg_b, tet_cols=False),
                                        s._builder.num_nodes)
    del held, fresh
    st6 = stats["as found"]
    row("pt_narrowphase", "pies_tpu_torch/kernels/csrc/pt_narrowphase.cu",
        "pies_tpu/collision/broadphase.py:385", 0.0,
        cuda_ms(lambda: t6(broadphase.pt_narrowphase, x), 20),
        cuda_ms(lambda: t6(broadphase.pt_narrowphase_plain, x), 3), "equal",
        # (the valid mask of every lane, the pair of each live lane)
        24 * n_body_nodes + 4 * lay.k * lay.e + 4 * lay.lanes + 4 * st6["live_lanes"]
        + 20 * lay.cap,
        864 * st6["live_lanes"] + 400 * st6["cross_combos"])

    colls = CollisionSet(floor_active=active, pt_idx=pk[0], pt_mask=pk[1], pt_count=pk[2],
                         overflow=zero())
    _, h2 = pd._h_h2(params)
    thick = params.collision_thickness
    dk, dp = diag.clone(), diag.clone()
    inc_k, ptd_k = tetcols.pt_coupling_setup(colls, st.mass, topo, h2, dk, wf, failed)
    inc_p, ptd_p = tetcols.pt_coupling_setup_plain(colls, st.mass, topo, h2, dp, wf, failed)
    con_k = tetcols.pt_force(x, colls, inc_k, thick, failed)
    con_p = tetcols.pt_force_plain(x, colls, inc_p, thick, failed)
    torch.cuda.synchronize()
    nnz, on = int(inc_p.row_start[-1]), incident(inc_p)
    n_inc = int(on.sum())
    same = (torch.equal(inc_k.row_start, inc_p.row_start)
            and torch.equal(inc_k.entries[:nnz], inc_p.entries[:nnz])
            and torch.equal(inc_k.nodes[:nnz], inc_p.nodes[:nnz])
            and torch.equal(ptd_k[on], ptd_p[on]) and torch.equal(dk, dp))
    check(same, f"T7 incidence, contact diagonal and system diagonal equal ({nnz} entries,"
                f" {n_inc} nodes)")
    ulps = max_ulp(con_k[on], con_p[on])
    err7 = float((con_k[on] - con_p[on]).abs().max())
    check(ulps <= 1.0, f"T7 contact force within 1 ulp (max {ulps} ulp)")

    def couple(setup, force):
        d = diag.clone()
        inc, _ = setup(colls, st.mass, topo, h2, d, wf, failed)
        for _ in range(cfg.iterations):
            force(x, colls, inc, thick, failed)

    row("pt_coupling", "pies_tpu_torch/kernels/csrc/pt_coupling.cu",
        "pies_tpu/solver/tetcols.py:194", err7,
        cuda_ms(lambda: couple(tetcols.pt_coupling_setup, tetcols.pt_force), 20),
        cuda_ms(lambda: couple(tetcols.pt_coupling_setup_plain, tetcols.pt_force_plain), 3),
        f"{ulps} ulp",
        # (the contacts and the incident nodes' rows read, row_start over
        # every node, the entries, nodes and node list written; then per
        # iteration the contacts and the incident rows again)
        20 * n_contacts + 24 * n_inc + 4 * (st.capacity + 1) + 8 * nnz + 4 * n_inc
        + cfg.iterations * (20 * n_contacts + 24 * n_inc),
        cfg.iterations * 50 * nnz)

    pt_args = (ptd_k, con_k, inc_k.row_start, colls.pt_count)
    one = (x, msn, dk, st.node_mask, wf, topo, plane, 1, failed, pt_args)
    ok2 = tetcols.substep_cols(*one)
    op2 = tetcols.substep_cols_plain(*one)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(ok2[:2], op2[:2]))
    check(err <= 1e-4, f"T2 one iteration with contacts within 1e-4 (max {err:.3e})")
    # The main path's form: T2's contact substep, the first iteration's tet
    # force computed inside (as pd_substep calls it), T7's force inside,
    # from the iterate each iteration starts from; bit-equal to its twin
    # (one twin call an iteration given T7's plain force).
    n_it = cfg.iterations
    sub = (x, msn, dk, st.node_mask, wf, topo, plane, n_it, failed)
    oc2 = tetcols.contact_substep(*sub, ptd_k, colls, inc_k, thick)
    pc2 = tetcols.contact_substep_plain(*sub, ptd_p, colls, inc_p, thick)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(oc2, pc2)),
          f"T2's contact substep ({n_it} iterations) equals its twin, bit for bit")
    n2 = x.shape[-2]
    on_t = on.view(-1, 4).any(1)
    n_ct = int(on_t.sum())
    print(f"  {n_ct} contact tets of {n2 // 4}; T2's contact launch keeps"
          f" {tetcols.contact_occupancy()} blocks an SM resident"
          f" (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    row(T2_CONTACT, "pies_tpu_torch/kernels/csrc/tet_cols_substep.cu",
        "pies_tpu/solver/tetcols.py:263", 0.0,
        cuda_ms(lambda: tetcols.contact_substep(*sub, ptd_k, colls, inc_k, thick), 20),
        cuda_ms(lambda: tetcols.contact_substep_plain(*sub, ptd_p, colls, inc_p, thick), 3),
        "equal",
        # (T2's substep over every column and row_start over every node
        # read once; the incident nodes' contact diagonal, the contacts and
        # the incidence entries and node list the force reads)
        424 * (n2 // 4) + 4 * (n2 + 1) + 8 * n_inc + 20 * n_contacts + 4 * nnz,
        n_it * 1600 * (n2 // 4) + n_it * 50 * nnz)
    rows["pt_coupling"]["form"] = (f"setup + {cfg.iterations} standalone forces (the generic"
                                   " path's form; the main path runs the force inside T2,"
                                   f" row {T2_CONTACT})")

    x_new, static_proj = oc2[0], oc2[1]
    sk, sp = clone_state(st), clone_state(st)
    xk, xp = x_new.clone(), x_new.clone()
    colls_a = CollisionSet(floor_active=active, pt_idx=pk[0], pt_mask=pk[1],
                           pt_count=pk[2], overflow=zero())
    frk = pd.pt_tail(sk, params, cfg, colls_a, inc_k, xk, static_proj)
    frp = pd.pt_tail_plain(sp, params, cfg, colls_a, inc_p, xp, static_proj)
    torch.cuda.synchronize()
    check(torch.equal(xk, xp) and torch.equal(sk.prev_positions, sp.prev_positions)
          and torch.equal(frk[on], frp[on]),
          "T8 pt_tail positions, prev and friction equal to the twin's, bit for bit")
    passes = cfg.collision_stabilization_iterations
    row("pt_tail", "pies_tpu_torch/kernels/csrc/pt_tail.cu", "pies_tpu/collision/batches.py:501",
        0.0, cuda_ms(lambda: pd.pt_tail(sk, params, cfg, colls_a, inc_k, xk, static_proj), 20),
        cuda_ms(lambda: pd.pt_tail_plain(sp, params, cfg, colls_a, inc_p, xp, static_proj), 3),
        "equal", passes * (20 * n_contacts + 64 * n_inc) + 20 * n_contacts + 56 * n_inc,
        passes * 60 * n_contacts + 90 * n_contacts)

    # The device work of each wrapper call of T5-T8 on this state, kernel by
    # kernel (the profiler's CUDA events): T5, T6 and T7's setup are one
    # cooperative launch a call and T7's force one launch, with no memcpy
    # and no memset.
    T5_REBUILD = "T5 rebuild (with the fill that forces it)"
    found, ov_t, d_t = st.bp.clone(), zero(), diag.clone()
    per_call = {
        "T5 as found": lambda: broadphase.body_broadphase(x, prev, tmask, found, lay, sc, ov_t,
                                                          failed),
        T5_REBUILD: lambda: rebuild(broadphase.body_broadphase),
        "T6": lambda: broadphase.pt_narrowphase(x, prev, tmask, cache, lay, sc, ov_t, failed),
        "T7 setup": lambda: tetcols.pt_coupling_setup(colls, st.mass, topo, h2, d_t, wf, failed),
        "T7 force": lambda: tetcols.pt_force(x, colls, inc_k, thick, failed),
        "T2 one contact iteration": lambda: tetcols.substep_cols(
            x, msn, dk, st.node_mask, wf, topo, plane, 1, failed, pt_args),
        "T2 contact substep": lambda: tetcols.contact_substep(*sub, ptd_k, colls, inc_k, thick),
        "T8": lambda: pd.pt_tail(sk, params, cfg, colls_a, inc_k, xk, static_proj),
    }
    print(f"  device work per call on this state ({smi}):")
    kinds, per_call_events = {}, {}
    for name, fn in per_call.items():
        events, every = device_kernels(fn)
        per_call_events[name] = events
        kinds[name] = device_kinds(events)
        k_, mc_, ms_, us_ = kinds[name]
        print(f"  {name}: {us_:.2f} us, {k_:g} kernels, {mc_:g} memcpys, {ms_:g} memsets")
        for key, (count, us) in sorted(events.items(), key=lambda kv: -kv[1][1]):
            print(f"    {us:9.2f} us x{count:<4g} {key[:90]}")
        # (every round's count of each name; a round below the largest lost records)
        print("    counts a call by round: " + "; ".join(
            ", ".join(f"{key[:40]} x{r.get(key, 0):g}" for key in events) for r in every))

    def t5_kernel(name):  # (T5's own launches and device µs a call)
        events = per_call_events[name]
        return (sum(c for key, (c, _) in events.items() if "bp_kernel" in key),
                sum(us for key, (_, us) in events.items() if "bp_kernel" in key))

    (t5_found, us_found), (t5_rb, us_rb) = t5_kernel("T5 as found"), t5_kernel(T5_REBUILD)
    check(kinds["T5 as found"][:3] == (1, 0, 0) and t5_found == 1,
          f"T5 as found: one kernel a call, no memcpy, no memset ({us_found:.2f} us)")
    check(kinds[T5_REBUILD][0] <= 2 and kinds[T5_REBUILD][1:3] == (0, 0) and t5_rb == 1,
          f"T5 with a rebuild: {kinds[T5_REBUILD][0]:g} kernels a call with the fill that"
          f" forces it, one of them T5's ({us_rb:.2f} us), no memcpy, no memset")
    rows["body_broadphase"].update(device_us=us_rb, kernels_per_call=t5_rb,
                                   found_device_us=us_found, found_kernels_per_call=t5_found)
    check(kinds["T6"][0] <= 3 and kinds["T6"][1:3] == (0, 0),
          f"T6: {kinds['T6'][0]:g} kernels, no memcpy, no memset a call")
    check(kinds["T7 setup"][0] <= 3 and kinds["T7 setup"][2] == 0,
          f"T7 setup: {kinds['T7 setup'][0]:g} kernels, no memset a call")
    check(kinds["T7 force"][:3] == (1, 0, 0), "T7 force: one kernel a call")
    check(kinds["T2 contact substep"][:3] == (1, 0, 0),
          "T2's contact substep: one kernel a call, no memcpy, no memset")
    check(kinds["T8"][:3] == (1, 0, 0), "T8: one kernel a call, no memcpy, no memset")
    rows["pt_narrowphase"]["device_us"] = kinds["T6"][3]
    rows["pt_coupling"]["device_us"] = kinds["T7 setup"][3] + cfg.iterations * kinds["T7 force"][3]
    rows[T2_CONTACT]["device_us"] = kinds["T2 contact substep"][3]
    rows[T2_CONTACT]["kernels_per_call"] = kinds["T2 contact substep"][0]
    rows["pt_tail"]["device_us"] = kinds["T8"][3]
    rows["pt_tail"]["kernels_per_call"] = kinds["T8"][0]
    del s, st, sk, sp, cache, timing_cache, colls, colls_a, inc_k, inc_p, found

    stamp("2b")

    # ---- phases 3 and 3b
    wrappers = kernel_wrappers()

    def reset_launches():
        for fns in wrappers.values():
            for f in fns:
                f.launches = 0

    def read_launches():
        return {name: sum(f.launches for f in fns) for name, fns in wrappers.items()}

    def prepare(n, collisions, scene, warm, plain):
        s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=collisions, device=dev)
        s.create_tet_soup(n, **scene)
        advance(s, warm, plain)
        return s

    def advance(s, ticks, plain, counters=None, sync_check=False):
        """``ticks`` ticks of the twins or of the kernels (``Solver.run_ticks``);
        with ``sync_check`` the kernels' ticks are enqueued by ``step.tick_n``
        under ``torch.cuda.set_sync_debug_mode("error")`` (a call among them
        that makes the host wait for the device raises), the closing
        synchronize outside it."""
        if plain:
            step.tick_n(s.state, s.topology, s.current_params(), s.config, ticks, plain=True,
                        counters=counters)
            torch.cuda.synchronize()
        elif sync_check:
            env = (s.state, s.topology, s.current_params(), s.config)
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = step.tick_n(*env, ticks, counters=counters)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            if res is not None:
                s.last_residual = res
            s.ticks += ticks
            s.render_state_dirty = True
        else:
            s.counters = counters
            s.run_ticks(ticks)
            s.counters = None

    def window(s, ticks, plain, sync_check=False):
        """``ticks`` timed ticks with the device counters on; returns the
        seconds per tick and the counters.  ``sync_check``: see
        :func:`advance`."""
        counters = pd.new_counters(dev)
        t0 = time.perf_counter()
        advance(s, ticks, plain, counters, sync_check)
        return (time.perf_counter() - t0) / ticks, {k: int(v) for k, v in counters.items()}

    def operator_csr(st, topo, wf, h2):
        """The whole operator as one CSR matrix (the ELL's nonzero slots plus
        the diagonal mass/h² + wf + static weight) for the library's sparse
        product."""
        n, m = st.capacity, topo.ell_nbr.shape[0]
        ids = torch.arange(n, device=dev)
        live = topo.ell_coef.reshape(-1) != 0
        dg = st.mass / h2 + wf + (topo.static_w if topo.static_w.shape[0] == n else 0.0)
        rows_, cols_, vals_ = [ids.repeat(m)[live], ids], \
            [topo.ell_nbr.reshape(-1).long()[live], ids], [topo.ell_coef.reshape(-1)[live], dg]
        if topo.tet_band is not None:  # the tets' seven diagonals, wrapping as jnp.roll
            for d in range(-3, 4):
                on = topo.tet_band[3 + d] != 0
                rows_.append(ids[on])
                cols_.append(((ids + d) % n)[on])
                vals_.append(topo.tet_band[3 + d][on])
        coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows_), torch.cat(cols_)]),
                                      torch.cat(vals_), (n, n))
        return coo.coalesce().to_sparse_csr()

    launches = {}
    # (the main path's wrappers: T1's force runs inside T2, so its own
    # wrapper launches nothing there)
    main_path = [n for n in list(wrappers)[:8] if n != "tet_force12"]
    for phase, collisions, warm, names in (
            ("3", False, FLOOR_WARMUP, main_path[:3]),
            ("3b", True, CONTACT_WARMUP, main_path)):
        what = "with self-contact" if collisions else "contact-free"
        print(f"phase {phase}: the main path {what}, {4 * n_tets} particles,"
              f" {warm} warm-up ticks")
        s = prepare(n_tets, collisions, SCENE, warm, False)
        if collisions:  # phase 20b starts from this state, at tick 45
            domain_keep["20b"] = (clone_state(s.state), s.topology, s.current_params(), s.config)
        reset_launches()
        # (3b's ticks are enqueued under the sync check: a call among them
        # that makes the host wait for the device raises)
        sec, counts = window(s, 10, False, sync_check=collisions)
        launches[phase] = read_launches()
        if collisions:
            check(True, "the window's 10 ticks enqueued under"
                        " torch.cuda.set_sync_debug_mode('error')")
            setups, t2 = tetcols.pt_coupling_setup.launches, tetcols.contact_substep.launches
            check(tetcols.pt_force.launches == 0 and tetcols.substep_cols.launches == 0
                  and t2 == setups,
                  f"every T2 call a contact substep with T7's force inside, one a substep"
                  f" ({t2} contact substeps, {setups} T7 setups, {tetcols.pt_force.launches}"
                  " standalone forces)")
            # The device work of the same window, traced from the state at
            # tick 45 on a copy: kernels, memcpys and memsets per tick.
            after, s._state = s._state, clone_state(domain_keep["20b"][0])
            counted = {f: f.launches for fns in wrappers.values() for f in fns}
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                s.run_ticks(10)
                wall = (time.perf_counter() - t0) / 10
            s._state, s.ticks = after, s.ticks - 10
            for f, n in counted.items():  # (the window's counts stand)
                f.launches = n
            events = {e.key: (e.count / 10, us / 10) for e, us in device_events(prof)}
            k_, mc_, ms_, us_ = device_kinds(events)
            print(f"  traced copy of the window: {wall * 1e3:.3f} ms/tick, device busy"
                  f" {us_ / 1e3:.4f} ms/tick ({100 * us_ / 1e3 / (wall * 1e3):.1f}%), {k_:g}"
                  f" kernels, {mc_:g} memcpys, {ms_:g} memsets per tick ({smi})")
            for key, (count, us) in sorted(events.items(), key=lambda kv: -kv[1][1]):
                print(f"    {us:9.2f} us/tick x{count:<5g} {key[:90]}")
            subs = setups / 10  # (substeps a tick: one T7 setup each)

            def per_tick(name):
                return sum(c for key, (c, _) in events.items() if name in key)

            t2k, t8k = per_tick("tet_cols_"), per_tick("pt_tail_kernel")
            t5k = per_tick("bp_kernel")
            calls = sum(launches[phase][n] for n in names) / 10
            check(mc_ == 0 and ms_ == 0 and subs > 0 and t2k == subs and t8k == subs
                  and t5k == subs,
                  f"a tick: {calls:g} wrapper calls, {k_:g} kernels (T5 {t5k:g}, T2's contact"
                  f" substep {t2k:g}, T8 {t8k:g}), {mc_:g} memcpys, {ms_:g} memsets,"
                  f" {us_:.2f} us of device busy ({subs:g} substeps)")
            check(launches[phase]["tet_force12"] == 0,
                  "T1 launched no time: T2 computes the first iteration's force")
        live = 4 * n_tets
        pos = s.state.positions[:live]
        check(not s.sim_failed, "no sim_failed")
        check(bool(torch.isfinite(pos).all()), "all positions finite")
        check(counts["floor_active"] > 0,
              f"floor contact in the window: {counts['floor_active']} node-substeps")
        if collisions:
            check(counts["contacts"] > 0,
                  f"self-contact in the window: {counts['contacts'] / 10:.1f} contacts per tick,"
                  f" {counts['rebuilds']} cache rebuilds in 10 ticks")
        check(all(launches[phase][n] > 0 for n in names),
              f"every kernel launched: {launches[phase]}")
        print(f"  kernels: {sec * 1e3:.3f} ms/tick, {1.0 / sec:.2f} steps/s ({smi};"
              f" residual {s.last_residual:.4g}; counters {counts})")
        s_plain = prepare(n_tets, collisions, SCENE, warm, True)
        sec_p, counts_p = window(s_plain, 10, True)
        check(read_launches() == launches[phase], "the twins launch no kernel")
        print(f"  plain twins: {sec_p * 1e3:.3f} ms/tick, {1.0 / sec_p:.2f} steps/s ({smi};"
              f" counters {counts_p})")
        d = float((s_plain.state.positions[:live] - pos).abs().max())
        check(d <= 1e-3, f"kernels and twins agree after {warm + 10} ticks: max |dx| {d:.3e}")
        check(counts_p == counts, "the same counters")
        if collisions:
            soup_3b = s  # phase 11b starts from this state
        del s, s_plain, pos

    stamp("3 and 3b")

    # ---- phase 4
    print(f"phase 4: 40 ticks of a {n_small}-tet soup, kernels against twins")
    runs = []
    for plain in (False, True):
        s = prepare(n_small, False, SCENE, 40, plain)
        check(not s.sim_failed, f"no sim_failed (plain={plain})")
        runs.append(s.state.positions[: 4 * n_small])
    d = float((runs[0] - runs[1]).abs().max())
    check(d <= 1e-3, f"trajectories agree: max |dx| {d:.3e}")
    check(float(runs[0][:, 1].min()) < 0.05, "the floor was reached")
    print(f"phase 4, self-contact: 40 ticks of a {n_small}-tet soup at spacing 1.0")
    runs, per_tick = [], []
    for plain in (False, True):
        s = prepare(n_small, True, DENSE_SCENE, 0, plain)
        counts = []
        for _ in range(40):
            c = pd.new_counters(dev)
            advance(s, 1, plain, c)
            counts.append(int(c["contacts"]))
        check(not s.sim_failed, f"no sim_failed (plain={plain})")
        runs.append(s.state.positions[: 4 * n_small])
        per_tick.append(counts)
    check(per_tick[0] == per_tick[1] and sum(per_tick[0]) > 0,
          f"contact counts equal on every tick: {per_tick[0]}")
    d = float((runs[0] - runs[1]).abs().max())
    check(d <= 1e-3, f"trajectories agree: max |dx| {d:.3e}")

    stamp("4")

    # ---- phase 5 (with 2c)
    generic = ["substep_head", "tet_force_nodes", "ell_matvec", "pcg", "substep_tail"]
    print(f"phase 5: the generic path on {mesh_big}")
    t0 = time.perf_counter()
    s = mesh_solver(pt, mesh_big, dev)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    n_nodes, n_live = st.capacity, s._builder.num_nodes
    n_tets, m = topo.strain.idx.shape[0], topo.ell_nbr.shape[0]
    pinned = int(topo.position.idx.shape[0] > 0)
    state_mb = sum(t.numel() * t.element_size() for t in (
        topo.ell_nbr, topo.ell_coef, topo.row_inc.row_start, topo.row_inc.entries,
        topo.row_inc.nodes,
        topo.strain.idx, topo.strain.qinv, topo.strain.g, topo.strain.lo, topo.strain.hi,
        topo.strain.w, topo.volume.lo, topo.volume.hi, topo.volume.w)) / 1e6
    print(f"set-up {time.perf_counter() - t0:.2f} s: {n_live} nodes (capacity {n_nodes}),"
          f" {n_tets} tet rows, ELL width {m}, {state_mb:.1f} MB of topology on the card;"
          f" path {'tet-column' if tetcols.applies(st, topo, cfg) else 'generic'}")
    check(not tetcols.applies(st, topo, cfg), "the mesh takes the generic path")
    t0 = time.perf_counter()
    s.run_ticks(mesh_warmup - 15)
    first = None
    for tick in range(mesh_warmup - 15, mesh_warmup):
        c = pd.new_counters(dev)
        advance(s, 1, False, c)
        if first is None and int(c["floor_active"]) > 0:
            first = tick + 1
    print(f"{mesh_warmup} warm-up ticks of the kernels: {time.perf_counter() - t0:.2f} s;"
          f" first floor contact at tick {first}")
    check(first is not None and not s.sim_failed, "floor contact in the warm-up, no sim_failed")
    warm = clone_state(s.state)

    print(f"phase 2c: T9-T11 against twins on the warmed {n_live}-node mesh")
    failed = st.sim_failed
    x, msn, diag, wf, active = pd.substep_head_plain(clone_state(st), topo, params, cfg, True)
    check(float(active.sum()) > 0, f"floor-active nodes in the state: {int(active.sum())}")
    _, h2 = pd._h_h2(params)
    bk = proj.tet_force12_gathered(x, topo.strain, topo.volume, failed)
    bp = proj.tet_force12_gathered_plain(x, topo.strain, topo.volume)
    fk = assembly.assemble_force(x, msn, wf, bk, topo, plane, failed)
    fp = assembly.assemble_force_plain(x, msn, wf, bp, topo, plane)
    torch.cuda.synchronize()
    scale = float(fp[0].abs().max())
    err = max(float((bk - bp).abs().max()), float((fk[0] - fp[0]).abs().max()))
    ulps = max(max_ulp(bk, bp), max_ulp(fk[0], fp[0]), max_ulp(fk[1], fp[1]))
    check(err <= 1e-6 * scale, f"T9 tet forces, force and static projection within 1e-6 of"
                               f" max |f| = {scale:.4g} ({ulps} ulp)")

    def t9(gather, assemble):
        blocks = gather(x, topo.strain, topo.volume, failed)
        assemble(x, msn, wf, blocks, topo, plane, failed)

    row("tet_force_nodes", "pies_tpu_torch/kernels/csrc/tet_force_nodes.cu",
        "pies_tpu/solver/assembly.py:188", err,
        cuda_ms(lambda: t9(proj.tet_force12_gathered, assembly.assemble_force), 20),
        cuda_ms(lambda: t9(proj.tet_force12_gathered_plain, assembly.assemble_force_plain), 3),
        f"{ulps} ulp", 124 * n_tets + (52 + 12 * pinned) * n_nodes,
        1500 * n_tets + 12 * 4 * n_tets, index_add_ms(topo.row_inc, bk, n_nodes))

    yk, pk = assembly.apply_system(x, st.mass, wf, h2, topo, failed, part=True)
    yp, pp = assembly.apply_system_plain(x, st.mass, wf, h2, topo, part=True)
    # The same operator as one CSR matrix (the ELL's nonzero slots plus the
    # diagonal mass/h² + wf + pin weight) for the library's sparse product.
    csr = operator_csr(st, topo, wf, h2)
    lib_y = torch.sparse.mm(csr, x)
    torch.cuda.synchronize()
    err = float((yk - yp).abs().max())
    lib_err = float((lib_y - yk).abs().max()) / float(yk.abs().max())
    check(torch.equal(yk, yp) and torch.equal(pk, pp),
          f"T10 ell_matvec and its p.Ap partials equal (library CSR product within"
          f" {lib_err:.2e} relative)")
    row("ell_matvec", "pies_tpu_torch/kernels/csrc/ell_matvec.cu",
        "pies_tpu/solver/assembly.py:448", err,
        cuda_ms(lambda: assembly.apply_system(x, st.mass, wf, h2, topo, failed, part=pk,
                                              out=yk), 50),
        cuda_ms(lambda: assembly.apply_system_plain(x, st.mass, wf, h2, topo, part=True), 5),
        "equal", (8 * m + 32) * n_nodes, (6 * m + 9) * n_nodes,
        library_ms=cuda_ms(lambda: torch.sparse.mm(csr, x), 50))
    del csr, lib_y

    cg_args = (fk[0], x, diag, st.mass, wf, h2, st.node_mask, topo, cfg.cg_iterations,
               cfg.cg_rtol)
    ok = assembly.pcg_solve(*cg_args, failed)
    op = assembly.pcg_solve_plain(*cg_args, failed)
    torch.cuda.synchronize()
    trips = int(ok[2][0])
    same = (torch.equal(ok[0], op[0]) and torch.equal(ok[1], op[1])
            and trips == int(op[2][0]))
    check(same, f"T11 pcg solution, residual partials and trips equal ({trips} trips of"
                f" {cfg.cg_iterations}, residual {float(ok[1].sum().sqrt()):.6g})")
    row("pcg", "pies_tpu_torch/kernels/csrc/pcg.cu",
        "pies_tpu/solver/assembly.py:656", float((ok[0] - op[0]).abs().max()),
        cuda_ms(lambda: assembly.pcg_solve(*cg_args, failed), 20),
        cuda_ms(lambda: assembly.pcg_solve_plain(*cg_args, failed), 2), "equal, same trips",
        (trips + 1) * (8 * m + 32) * n_nodes + 88 * n_nodes + trips * 128 * n_nodes,
        (trips + 1) * (6 * m + 9) * n_nodes + trips * 30 * n_nodes)
    del bk, bp, fk, fp, yk, yp, ok, op

    reset_launches()
    sec, counts = window(s, 10, False)
    launches["5"] = read_launches()
    pos = s.state.positions[:n_live]
    check(not s.sim_failed, "no sim_failed")
    check(bool(torch.isfinite(pos).all()), "all positions finite")
    check(counts["floor_active"] > 0,
          f"floor contact in the window: {counts['floor_active']} node-substeps")
    check(all(launches["5"][n] > 0 for n in generic),
          f"every kernel of the path launched: {launches['5']}")
    per_tick = {n: launches["5"][n] / 10 for n in generic}
    print(f"  kernels: {sec * 1e3:.3f} ms/tick, {1.0 / sec:.2f} steps/s ({smi}; residual"
          f" {s.last_residual:.6g}; {counts['cg_trips'] / 10:.1f} CG trips per tick; launches"
          f" per tick {per_tick})")
    runs = []
    for plain in (False, True):
        w = clone_state(warm)
        c = pd.new_counters(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.tick_n(w, topo, params, cfg, 3, plain=plain, counters=c)
        torch.cuda.synchronize()
        runs.append((w, {k: int(v) for k, v in c.items()}, (time.perf_counter() - t0) / 3))
    check(read_launches() != launches["5"] and not runs[0][0].failed()
          and not runs[1][0].failed(), "the kernels' run launched, no sim_failed in either")
    d = float((runs[0][0].positions[:n_live] - runs[1][0].positions[:n_live]).abs().max())
    check(d <= 1e-3 and runs[0][1] == runs[1][1],
          f"kernels and twins agree over ticks 76-78: max |dx| {d:.3e}, counters {runs[0][1]}")
    print(f"  plain twins: {runs[1][2] * 1e3:.3f} ms/tick ({smi})")
    mesh_off = pos.clone()  # collisions off, mesh_warmup + 10 ticks: phase 5b compares
    mesh_5 = (s, warm)  # phase 11d starts from the warmed state
    domain_keep["20a"] = (clone_state(warm), topo, params, cfg, n_live)  # phase 20a too
    del s, st, warm, runs, pos

    print(f"phase 5, small mesh: 40 ticks of {MESH_SMALL} with 4 pins, kernels against twins")
    runs = []
    for plain in (False, True):
        s = mesh_solver(pt, MESH_SMALL, dev, SMALL_PINS)
        c = pd.new_counters(dev)
        step.tick_n(s.state, s.topology, s.current_params(), s.config, 40, plain=plain,
                    counters=c)
        check(not s.sim_failed, f"no sim_failed (plain={plain})")
        runs.append((s.state.positions[: s._builder.num_nodes], {k: int(v) for k, v in c.items()}))
    d = float((runs[0][0] - runs[1][0]).abs().max())
    check(d <= 1e-3 and runs[0][1] == runs[1][1] and runs[0][1]["floor_active"] > 0,
          f"trajectories agree: max |dx| {d:.3e}, counters {runs[0][1]}")

    stamp("5")

    # ---- phase 6 (with 2d)
    from pies_tpu_torch.scene.rigged_cloth import add_rigged_cloth, fixed_region_matrix
    from pies_tpu_torch.topology import row_layout

    cloth_path = ["substep_head", "constraint_rows", "shape_match", "tet_force_nodes",
                  "ell_matvec", "pcg", "substep_tail"]
    print(f"phase 6: the rigged cloth, {cloth_n} x {cloth_n} nodes")
    t0 = time.perf_counter()
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=False, device=dev)
    add_rigged_cloth(s, cloth_n, **CLOTH)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    n_nodes, n_live, m = st.capacity, s._builder.num_nodes, topo.ell_nbr.shape[0]
    lay = row_layout(topo)
    n_rows = sum(r for _, r in lay.values())
    c_dist, c_bend = topo.distance.idx.shape[0], topo.bend.idx.shape[0]
    m_shape, g_shape = topo.shape.node_idx.shape[0], topo.shape.num_groups
    m_goal, g_goal = topo.goal.node_idx.shape[0], topo.goal.num_groups
    print(f"set-up {time.perf_counter() - t0:.2f} s: {n_live} nodes (capacity {n_nodes}),"
          f" {c_dist} distance rows, {c_bend} bend rows, {int(topo.tri_mask.sum())} triangles,"
          f" {g_shape} shape groups ({m_shape} members), {g_goal} goal group(s) ({m_goal}"
          f" members), ELL width {m}, {n_rows} force rows")
    check(not tetcols.applies(st, topo, cfg) and topo.strain.idx.shape[0] == 0,
          "the cloth takes the generic path, without tets")
    t0 = time.perf_counter()
    first = None
    for tick in range(60):
        c = pd.new_counters(dev)
        advance(s, 1, False, c)
        if int(c["floor_active"]) > 0:
            first = tick + 1
            break
    print(f"warm-up ticks of the kernels: {time.perf_counter() - t0:.2f} s; first floor contact"
          f" at tick {first}")
    check(first is not None and not s.sim_failed, "floor contact in the warm-up, no sim_failed")
    s.update_fixed_regions([fixed_region_matrix(cloth_n, CLOTH["scale"], CLOTH["height"],
                                                CLOTH_TURN)])
    advance(s, 1, False)  # one tick with the region turned: the state phase 2d reads
    warm = clone_state(s.state)

    print(f"phase 2d: T12, T13, T9 stage 2 and T10 against twins on the warmed {n_live}-node"
          " cloth")
    failed = st.sim_failed
    x, msn, diag, wf, active = pd.substep_head_plain(clone_state(st), topo, params, cfg, True)
    check(float(active.sum()) > 0, f"floor-active nodes in the state: {int(active.sum())}")
    _, h2 = pd._h_h2(params)
    dk = proj.distance_rows(x, topo.distance, failed)
    dp = proj.distance_rows_plain(x, topo.distance)
    bk = proj.bend_rows(x, st.inv_mass, topo.bend, failed)
    bp = proj.bend_rows_plain(x, st.inv_mass, topo.bend)
    torch.cuda.synchronize()
    scale_b = float(bp.abs().max())
    err_b = float((bk - bp).abs().max())
    check(torch.equal(dk, dp), "T12 distance rows equal")
    check(err_b <= 1e-6 * scale_b, f"T12 bend rows within 1e-6 of max |row| = {scale_b:.4g}"
                                   f" (max err {err_b:.3e}, {max_ulp(bk, bp)} ulp)")
    row("constraint_rows", "pies_tpu_torch/kernels/csrc/constraint_rows.cu",
        "pies_tpu/constraints/projections.py:48", err_b,
        cuda_ms(lambda: (proj.distance_rows(x, topo.distance, failed),
                         proj.bend_rows(x, st.inv_mass, topo.bend, failed)), 20),
        cuda_ms(lambda: (proj.distance_rows_plain(x, topo.distance),
                         proj.bend_rows_plain(x, st.inv_mass, topo.bend)), 3),
        f"distance equal, bend {max_ulp(bk, bp)} ulp",
        40 * c_dist + 72 * c_bend + 16 * n_nodes, 30 * c_dist + 250 * c_bend)

    def t13(shape_fn, goal_fn, quats):
        return (shape_fn(x, st.mass, quats, topo.shape, cfg.rotation_iterations, failed),
                goal_fn(topo.goal, failed))

    qk, qp = st.shape_quats.clone(), st.shape_quats.clone()
    sk, gk = t13(proj.shape_rows, proj.goal_rows, qk)
    sp, gp = t13(proj.shape_rows_plain, proj.goal_rows_plain, qp)
    torch.cuda.synchronize()
    scale_s = float(sp.abs().max())
    err_s = float((sk - sp).abs().max())
    err_q = float((qk - qp).abs().max())
    turned = float((qk - torch.tensor([1.0, 0, 0, 0], device=dev)).abs().max())
    check(torch.equal(gk, gp), "T13 goal rows equal")
    check(err_s <= 1e-6 * scale_s and err_q <= 1e-6,
          f"T13 shape rows within 1e-6 of max |row| = {scale_s:.4g} (max err {err_s:.3e},"
          f" {max_ulp(sk, sp)} ulp) and rotations within 1e-6 (max err {err_q:.3e}); the"
          f" groups have turned by up to {turned:.3e}")
    check(turned > 1e-4, "the shape groups have turned")
    scratch_q = st.shape_quats.clone()
    row("shape_match", "pies_tpu_torch/kernels/csrc/shape_match.cu",
        "pies_tpu/constraints/projections.py:446", max(err_s, err_q),
        cuda_ms(lambda: t13(proj.shape_rows, proj.goal_rows, scratch_q.copy_(st.shape_quats)), 20),
        cuda_ms(lambda: t13(proj.shape_rows_plain, proj.goal_rows_plain,
                            scratch_q.copy_(st.shape_quats)), 3),
        f"goal equal, shape {max_ulp(sk, sp)} ulp",
        48 * m_shape + 92 * g_shape + 36 * m_goal + 64 * g_goal,
        60 * m_shape + 200 * cfg.rotation_iterations * g_shape + 20 * m_goal)

    rows_k = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats.clone(), topo,
                                 cfg.rotation_iterations, failed)
    fk = assembly.assemble_force(x, msn, wf, rows_k, topo, plane, failed)
    fp = assembly.assemble_force_plain(x, msn, wf, rows_k, topo, plane)
    torch.cuda.synchronize()
    err = float((fk[0] - fp[0]).abs().max())
    check(torch.equal(fk[0], fp[0]) and torch.equal(fk[1], fp[1]),
          f"T9 stage 2 over {n_rows} rows of all families: force and static projection equal")
    row("assemble_force_cloth", "pies_tpu_torch/kernels/csrc/tet_force_nodes.cu",
        "pies_tpu/solver/assembly.py:188", err,
        cuda_ms(lambda: assembly.assemble_force(x, msn, wf, rows_k, topo, plane, failed), 20),
        cuda_ms(lambda: assembly.assemble_force_plain(x, msn, wf, rows_k, topo, plane), 3),
        "equal", 12 * n_rows + 52 * n_nodes, 3 * n_rows + 9 * n_nodes,
        index_add_ms(topo.row_inc, rows_k, n_nodes))

    yk, pk = assembly.apply_system(x, st.mass, wf, h2, topo, failed, part=True)
    yp, pp = assembly.apply_system_plain(x, st.mass, wf, h2, topo, part=True)
    csr = operator_csr(st, topo, wf, h2)
    lib_y = torch.sparse.mm(csr, x)
    torch.cuda.synchronize()
    lib_err = float((lib_y - yk).abs().max()) / float(yk.abs().max())
    check(torch.equal(yk, yp) and torch.equal(pk, pp),
          f"T10 with the distance Laplacian and the static weight (ELL width {m}): product and"
          f" p.Ap partials equal (library CSR product within {lib_err:.2e} relative)")
    row("ell_matvec_cloth", "pies_tpu_torch/kernels/csrc/ell_matvec.cu",
        "pies_tpu/solver/assembly.py:448", float((yk - yp).abs().max()),
        cuda_ms(lambda: assembly.apply_system(x, st.mass, wf, h2, topo, failed, part=pk,
                                              out=yk), 50),
        cuda_ms(lambda: assembly.apply_system_plain(x, st.mass, wf, h2, topo, part=True), 5),
        "equal", (8 * m + 36) * n_nodes, (6 * m + 12) * n_nodes,
        library_ms=cuda_ms(lambda: torch.sparse.mm(csr, x), 50))
    del csr, lib_y

    cg_args = (fk[0], x, diag, st.mass, wf, h2, st.node_mask, topo, cfg.cg_iterations,
               cfg.cg_rtol)
    ok = assembly.pcg_solve(*cg_args, failed)
    op = assembly.pcg_solve_plain(*cg_args, failed)
    torch.cuda.synchronize()
    trips = int(ok[2][0])
    check(torch.equal(ok[0], op[0]) and torch.equal(ok[1], op[1]) and trips == int(op[2][0]),
          f"T11 on the cloth: solution, residual partials and trips equal ({trips} trips of"
          f" {cfg.cg_iterations})")
    row("pcg_cloth", "pies_tpu_torch/kernels/csrc/pcg.cu", "pies_tpu/solver/assembly.py:656",
        float((ok[0] - op[0]).abs().max()),
        cuda_ms(lambda: assembly.pcg_solve(*cg_args, failed), 20),
        cuda_ms(lambda: assembly.pcg_solve_plain(*cg_args, failed), 2), "equal, same trips",
        (trips + 1) * (8 * m + 36) * n_nodes + 88 * n_nodes + trips * 128 * n_nodes,
        (trips + 1) * (6 * m + 12) * n_nodes + trips * 30 * n_nodes)
    del dk, dp, bk, bp, sk, sp, gk, gp, rows_k, fk, fp, yk, yp, ok, op

    reset_launches()
    sec, counts = window(s, 10, False)
    launches["6"] = read_launches()
    pos = s.state.positions[:n_live]
    check(not s.sim_failed, "no sim_failed")
    check(bool(torch.isfinite(pos).all()), "all positions finite")
    check(counts["floor_active"] > 0,
          f"floor contact in the window: {counts['floor_active']} node-substeps")
    check(all(launches["6"][n] > 0 for n in cloth_path),
          f"every kernel of the path launched: {launches['6']}")
    check(not torch.equal(topo.goal.transforms[0], torch.eye(4, device=dev)),
          "the goal transform is not the identity")
    per_tick = {n: launches["6"][n] / 10 for n in cloth_path}
    print(f"  kernels: {sec * 1e3:.3f} ms/tick, {1.0 / sec:.2f} steps/s ({smi}; residual"
          f" {s.last_residual:.6g}; {counts['cg_trips'] / 10:.1f} CG trips per tick; launches"
          f" per tick {per_tick})")
    runs = []
    for plain in (False, True):
        w = clone_state(warm)
        c = pd.new_counters(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.tick_n(w, topo, params, cfg, 3, plain=plain, counters=c)
        torch.cuda.synchronize()
        runs.append((w, {k: int(v) for k, v in c.items()}, (time.perf_counter() - t0) / 3))
    check(not runs[0][0].failed() and not runs[1][0].failed(), "no sim_failed in either run")
    d = float((runs[0][0].positions[:n_live] - runs[1][0].positions[:n_live]).abs().max())
    dq = float((runs[0][0].shape_quats - runs[1][0].shape_quats).abs().max())
    check(d <= 1e-3 and runs[0][1] == runs[1][1],
          f"kernels and twins agree over 3 ticks from the warmed state: max |dx| {d:.3e},"
          f" max |dq| {dq:.3e}, counters {runs[0][1]}")
    print(f"  plain twins: {runs[1][2] * 1e3:.3f} ms/tick ({smi})")
    cloth_off, cloth_first = pos.clone(), first  # collisions off: phase 6c compares
    keep["cloth"] = s  # phase 14c holds T28's distance and bend rows on its state
    del s, st, topo, warm, runs, pos

    stamp("6")

    # ---- phase 6b
    print(f"phase 6b: {n_blobs} shape-matching blobs, {125 * n_blobs} nodes")
    t0 = time.perf_counter()
    s = blob_solver(pt, n_blobs, dev)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    n_live = s._builder.num_nodes
    print(f"set-up {time.perf_counter() - t0:.2f} s: {n_live} nodes, {topo.shape.num_groups}"
          f" groups of {topo.shape.max_count}, ELL width {topo.ell_nbr.shape[0]}")
    advance(s, 5, False)
    warm = clone_state(s.state)
    x = st.positions
    qk, qp = st.shape_quats.clone(), st.shape_quats.clone()
    args13 = (x, st.mass)
    sk = proj.shape_rows(*args13, qk, topo.shape, cfg.rotation_iterations, st.sim_failed)
    sp = proj.shape_rows_plain(*args13, qp, topo.shape, cfg.rotation_iterations)
    torch.cuda.synchronize()
    scale_s, err_s = float(sp.abs().max()), float((sk - sp).abs().max())
    err_q = float((qk - qp).abs().max())
    check(err_s <= 1e-6 * scale_s and err_q <= 1e-6,
          f"T13 at {topo.shape.num_groups} groups of {topo.shape.max_count}: rows within 1e-6"
          f" of max |row| = {scale_s:.4g} (max err {err_s:.3e}), rotations within 1e-6 (max"
          f" err {err_q:.3e})")
    scratch_q = st.shape_quats.clone()
    ms13 = cuda_ms(lambda: proj.shape_rows(*args13, scratch_q.copy_(st.shape_quats), topo.shape,
                                           cfg.rotation_iterations, st.sim_failed), 20)
    ms13p = cuda_ms(lambda: proj.shape_rows_plain(*args13, scratch_q.copy_(st.shape_quats),
                                                  topo.shape, cfg.rotation_iterations), 3)
    b_ms, _ = bound(48 * topo.shape.node_idx.shape[0] + 92 * topo.shape.num_groups, 0)
    print(f"  T13 shape rows at this shape: kernel {ms13:.4f} ms, plain {ms13p:.4f} ms, bound"
          f" {b_ms:.4f} ms (bytes)")
    reset_launches()
    sec, counts = window(s, 10, False)
    launches["6b"] = read_launches()
    check(not s.sim_failed and bool(torch.isfinite(s.state.positions[:n_live]).all()),
          "no sim_failed, all positions finite")
    check(launches["6b"]["shape_match"] > 0 and launches["6b"]["pcg"] > 0,
          f"the path's kernels launched: {launches['6b']}")
    check(counts["cg_trips"] <= 40, f"Jacobi is exact on a diagonal system:"
                                    f" {counts['cg_trips']} CG trips in 10 ticks (40 solves)")
    print(f"  kernels: {sec * 1e3:.3f} ms/tick, {1.0 / sec:.2f} steps/s ({smi};"
          f" {counts['cg_trips'] / 10:.1f} CG trips per tick)")
    runs = []
    for plain in (False, True):
        w = clone_state(warm)
        c = pd.new_counters(dev)
        step.tick_n(w, topo, params, cfg, 3, plain=plain, counters=c)
        torch.cuda.synchronize()
        runs.append((w, {k: int(v) for k, v in c.items()}))
    d = float((runs[0][0].positions[:n_live] - runs[1][0].positions[:n_live]).abs().max())
    check(d <= 1e-3 and not runs[0][0].failed() and not runs[1][0].failed(),
          f"kernels and twins agree over 3 ticks: max |dx| {d:.3e}, counters {runs[0][1]},"
          f" twins' {runs[1][1]}")
    del s, st, topo, warm, runs


    stamp("6b")

    # ---- phase 7 (with 2e)
    from pies_tpu_torch.scene.mixed_drape import add_mixed_drape

    mixed_path = ["substep_head", "super_broadphase", "super_narrowphase", "pt_coupling",
                  "tet_force_nodes", "constraint_rows", "ell_matvec", "pcg", "pt_tail",
                  "substep_tail"]
    n_tets = soup_tets
    print(f"phase 7: the cloth over the soup, {n_tets} tets and a {mixed_sheet} x {mixed_sheet}"
          " sheet, default Solver arguments")
    t0 = time.perf_counter()
    s = pt.Solver(pt.SolverOptions(solver=PD), device=dev)
    add_mixed_drape(s, n_tets, mixed_sheet)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    n_nodes, n_live, n_soup = st.capacity, s._builder.num_nodes, 4 * n_tets
    lay = broadphase.super_layout(cfg, topo.super_corners, topo.super_adj)
    m = topo.ell_nbr.shape[0]
    cache_mb = (st.bp.pairs.numel() + st.bp.valid.numel()) * 4 / 1e6
    print(f"set-up {time.perf_counter() - t0:.2f} s: {n_live} nodes (capacity {n_nodes}),"
          f" {int(topo.tri_mask.sum())} triangles, {lay.live_k} collision rows ({lay.kp} packed,"
          f" W = {lay.w}, {lay.n_face} face slots, {len(lay.combos())} combos, {lay.a}"
          f" neighbours per row at most), {lay.lanes} lanes, cache {cache_mb:.1f} MB, contact"
          f" cap {lay.cap}, {lay.bmax} raw candidates and {lay.nb} slots per row, cell"
          f" {params.broadphase_cell:.3f}, ELL width {m} beside the band")
    check(cfg.enable_collisions and cfg.contact_coupling == "recentered" and cfg.super_k > 0
          and not tetcols.applies(st, topo, cfg) and topo.tet_band is not None,
          "default arguments: self-contact on, recentered coupling, the super-body layout, the"
          " generic path with the banded tet operator")

    def mixed_contacts(solver):
        """The next substep's contacts of ``solver`` (a detection on a copy
        of its state): how many, and how many between the sheet and the
        soup."""
        c = clone_state(solver.state)
        h = pd.substep_head_plain(c, solver.topology, solver.current_params(), solver.config,
                                  True)
        colls = pd.detect_point_tri(c, h[0], solver.topology, solver.current_params(),
                                    solver.config, h[4])
        idx = colls.pt_idx[: int(colls.pt_count[0])]
        point_soup = idx[:, 0] < n_soup
        cross = (point_soup != (idx[:, 1] < n_soup)) if idx.numel() else idx[:, 0] > 0
        return idx.shape[0], int(cross.sum())

    t0 = time.perf_counter()
    free = MIXED_FREE_FALL
    advance(s, free, False)
    first = None
    for tick in range(free, free + 60):
        n_all, n_cross = mixed_contacts(s)
        if n_cross > 0:
            first = tick
            break
        advance(s, 1, False)
    print(f"warm-up ticks of the kernels: {time.perf_counter() - t0:.2f} s; before tick {first}"
          f" {n_all} contacts, {n_cross} of them between the sheet and the soup")
    check(first is not None and not s.sim_failed,
          "sheet-soup contact in the warm-up, no sim_failed")
    warm = clone_state(s.state)

    print(f"phase 2e: T14, T15, T7, T9 stage 2, T10's band form and T11 against twins on the"
          f" warmed {n_live}-node scene")
    failed = st.sim_failed
    x, msn, diag, wf, active = pd.substep_head_plain(clone_state(st), topo, params, cfg, True)
    prev, corners, adj = st.prev_positions, topo.super_corners, topo.super_adj
    sc = broadphase.scalars(params)
    _, h2 = pd._h_h2(params)

    def t14(fn, force, **kw):
        c, ov = st.bp.clone(), zero()
        if force:
            c.fresh.zero_()
        rb = fn(x, prev, corners, adj, c, lay, sc, ov, failed, **kw)
        return c, ov, rb

    for force in (False, True):
        flags = []
        (c14k, ov14k, rbk), (c14p, ov14p, rbp) = (
            t14(broadphase.super_broadphase, force, flags_out=flags),
            t14(broadphase.super_broadphase_plain, force))
        torch.cuda.synchronize()
        same = (all(torch.equal(getattr(c14k, f), getattr(c14p, f)) for f in cache_fields)
                and torch.equal(ov14k, ov14p) and int(rbk[0]) == int(rbp[0]))
        named = dict(zip(broadphase.SUPER_FLAGS, flags[0].tolist())) if flags else {}
        check(same, f"T14 super_broadphase cache, latch and rebuild flag equal (rebuild forced"
                    f" {force}, rebuilt {int(rbk[0])}, valid pairs {int(c14k.valid.sum())},"
                    f" most per row {int(c14k.valid.sum(1).max())}, overflow {int(ov14k[0])},"
                    f" flags {named})")
    check(int(ov14k[0]) == 0, "no capacity latch on the warmed state")
    cache = c14k
    timing_cache, ov = st.bp.clone(), zero()

    def rebuild14(fn, force=True):
        if force:
            timing_cache.fresh.zero_()
        fn(x, prev, corners, adj, timing_cache, lay, sc, ov, failed)

    a_width = lay.a
    row("super_broadphase", "pies_tpu_torch/kernels/csrc/super_broadphase.cu",
        "pies_tpu/collision/broadphase.py:647", 0.0,
        cuda_ms(lambda: rebuild14(broadphase.super_broadphase), 20),
        cuda_ms(lambda: rebuild14(broadphase.super_broadphase_plain), 2), "equal",
        36 * n_nodes + 4 * lay.k * (lay.w + a_width) + 8 * lay.lanes + 4, 1000 * lay.k)
    # A substep that keeps its cached pairs: the slack is raised so that no
    # node has moved past it.
    calm = dataclasses.replace(sc, slack=1e30)
    rebuild14(broadphase.super_broadphase)  # leaves the cache fresh
    ms_keep = cuda_ms(lambda: broadphase.super_broadphase(
        x, prev, corners, adj, timing_cache, lay, calm, ov, failed), 20)
    b_keep, _ = bound(36 * n_nodes + 4 * lay.k * lay.w, 0)
    print(f"  T14 without a rebuild: kernel {ms_keep:.4f} ms, bound {b_keep:.4f} ms (bytes)")

    def t15(fn, xx, **kw):
        ovx = zero()
        out = fn(xx, prev, corners, cache, lay, sc, ovx, failed, **kw)
        return out, ovx

    rng = np.random.default_rng(1)
    jitter = torch.from_numpy((0.05 * rng.standard_normal(x.shape)).astype(np.float32)).to(dev)
    x_cross = x + jitter * st.node_mask[:, None]
    stats = {}
    for name, xx in (("as found", x), ("jittered", x_cross)):
        stats[name] = {}
        (pk, ovk), (pp, ovp) = t15(broadphase.super_narrowphase, xx), \
            t15(broadphase.super_narrowphase_plain, xx, stats=stats[name])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(pk, pp)) and torch.equal(ovk, ovp)
        check(same, f"T15 super_narrowphase contacts equal ({name}: {int(pk[2][0])} contacts,"
                    f" latch {int(ovk[0])}, {stats[name]})")
    check(stats["jittered"]["cross_combos"] > 0,
          f"T15 phase 2 ran: {stats['jittered']['cross_combos']} crossing combos")
    pk, _ = t15(broadphase.super_narrowphase, x)
    n_contacts = int(pk[2][0])
    check(n_contacts > 0, f"contacts in the state: {n_contacts}")
    st15 = stats["as found"]
    row("super_narrowphase", "pies_tpu_torch/kernels/csrc/super_narrowphase.cu",
        "pies_tpu/collision/broadphase.py:850", 0.0,
        cuda_ms(lambda: t15(broadphase.super_narrowphase, x), 20),
        cuda_ms(lambda: t15(broadphase.super_narrowphase_plain, x), 2), "equal",
        # (the valid mask of every lane, the pair of each live lane)
        24 * n_nodes + 4 * lay.k * lay.w + 4 * lay.lanes + 4 * st15["live_lanes"]
        + 20 * lay.cap,
        60 * len(lay.combos()) * st15["live_lanes"] + 400 * st15["cross_combos"])

    colls = CollisionSet(floor_active=active, pt_idx=pk[0], pt_mask=pk[1], pt_count=pk[2],
                         overflow=zero())
    thick = params.collision_thickness
    dk, dp, sdk, sdp = diag.clone(), diag.clone(), wf.clone(), wf.clone()
    inc_k, ptd_k = tetcols.pt_coupling_setup(colls, st.mass, topo, h2, dk, wf, failed, sdk)
    inc_p, ptd_p = tetcols.pt_coupling_setup_plain(colls, st.mass, topo, h2, dp, wf, failed,
                                                   sdp)
    con_k = tetcols.pt_force(x, colls, inc_k, thick, failed)
    con_p = tetcols.pt_force_plain(x, colls, inc_p, thick, failed)
    torch.cuda.synchronize()
    on = incident(inc_p)
    check(torch.equal(dk, dp) and torch.equal(sdk, sdp) and torch.equal(ptd_k[on], ptd_p[on])
          and not torch.equal(sdk, wf),
          f"T7 Jacobi diagonal, operator diagonal (floor + contacts) and contact diagonal equal"
          f" ({int(on.sum())} nodes with contact entries)")
    ulps = max_ulp(con_k[on], con_p[on])
    check(ulps <= 1.0, f"T7 contact force within 1 ulp (max {ulps} ulp)")

    rows_k = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats.clone(), topo,
                                 cfg.rotation_iterations, failed)
    n_rows = rows_k.shape[0]
    pt_k = (ptd_k, con_k, inc_k.row_start, colls.pt_count)
    pt_p = (ptd_p, con_p, inc_p.row_start, colls.pt_count)
    fk = assembly.assemble_force(x, msn, wf, rows_k, topo, plane, failed, pt_k)
    fp = assembly.assemble_force_plain(x, msn, wf, rows_k, topo, plane, None, pt_p)
    bare = assembly.assemble_force_plain(x, msn, wf, rows_k, topo, plane)
    torch.cuda.synchronize()
    err = float((fk[0] - fp[0]).abs().max())
    check(torch.equal(fk[0], fp[0]) and torch.equal(fk[1], fp[1])
          and not torch.equal(fk[0], bare[0]),
          f"T9 stage 2 with the contact terms over {n_rows} rows: force and static projection"
          f" equal (tolerance 0; the contact terms move the force by up to"
          f" {float((fk[0] - bare[0]).abs().max()):.4g})")
    row("assemble_force_contacts", "pies_tpu_torch/kernels/csrc/tet_force_nodes.cu",
        "pies_tpu/solver/assembly.py:288", err,
        cuda_ms(lambda: assembly.assemble_force(x, msn, wf, rows_k, topo, plane, failed, pt_k),
                20),
        cuda_ms(lambda: assembly.assemble_force_plain(x, msn, wf, rows_k, topo, plane, None,
                                                      pt_p), 3),
        "equal", 12 * n_rows + 52 * n_nodes + 20 * int(on.sum()), 3 * n_rows + 15 * n_nodes,
        index_add_ms(topo.row_inc, rows_k, n_nodes))

    yk, pk10 = assembly.apply_system(x, st.mass, sdk, h2, topo, failed, part=True)
    yp, pp10 = assembly.apply_system_plain(x, st.mass, sdp, h2, topo, part=True)
    csr = operator_csr(st, topo, sdk, h2)
    lib_y = torch.sparse.mm(csr, x)
    torch.cuda.synchronize()
    lib_err = float((lib_y - yk).abs().max()) / float(yk.abs().max())
    check(torch.equal(yk, yp) and torch.equal(pk10, pp10),
          f"T10 band form with the contact diagonal (seven tet diagonals, ELL width {m}):"
          f" product and p.Ap partials equal (tolerance 0; library CSR product within"
          f" {lib_err:.2e} relative)")
    row("ell_matvec_band", "pies_tpu_torch/kernels/csrc/ell_matvec.cu",
        "pies_tpu/solver/assembly.py:493", float((yk - yp).abs().max()),
        cuda_ms(lambda: assembly.apply_system(x, st.mass, sdk, h2, topo, failed, part=pk10,
                                              out=yk), 50),
        cuda_ms(lambda: assembly.apply_system_plain(x, st.mass, sdp, h2, topo, part=True), 5),
        "equal", (8 * m + 64) * n_nodes, (6 * m + 54) * n_nodes,
        library_ms=cuda_ms(lambda: torch.sparse.mm(csr, x), 50))
    del csr, lib_y

    cg_args = (fk[0], x, dk, st.mass, sdk, h2, st.node_mask, topo, cfg.cg_iterations,
               cfg.cg_rtol)
    ok = assembly.pcg_solve(*cg_args, failed)
    op = assembly.pcg_solve_plain(*cg_args, failed)
    torch.cuda.synchronize()
    trips = int(ok[2][0])
    check(torch.equal(ok[0], op[0]) and torch.equal(ok[1], op[1]) and trips == int(op[2][0]),
          f"T11 with the contact diagonal: solution, residual partials and trips equal ({trips}"
          f" trips of {cfg.cg_iterations})")
    ms_cg = cuda_ms(lambda: assembly.pcg_solve(*cg_args, failed), 20)
    ms_cgp = cuda_ms(lambda: assembly.pcg_solve_plain(*cg_args, failed), 2)
    b_cg, _ = bound((trips + 1) * (8 * m + 64) * n_nodes + 88 * n_nodes + trips * 128 * n_nodes,
                    0)
    print(f"  T11 a whole solve on this scene: kernel {ms_cg:.4f} ms, plain {ms_cgp:.4f} ms,"
          f" bound {b_cg:.4f} ms (bytes)")
    del rows_k, fk, fp, bare, yk, yp, ok, op, cache, timing_cache, colls, inc_k, inc_p

    reset_launches()
    sec, counts = window(s, 10, False)
    launches["7"] = read_launches()
    pos = s.state.positions[:n_live]
    check(not s.sim_failed, "no sim_failed")
    check(bool(torch.isfinite(pos).all()), "all positions finite")
    check(counts["floor_active"] > 0,
          f"floor contact in the window: {counts['floor_active']} node-substeps")
    check(counts["contacts"] > 0,
          f"contacts in the window: {counts['contacts'] / 10:.1f} per tick,"
          f" {counts['rebuilds']} cache rebuilds in 10 ticks")
    n_all, n_cross = mixed_contacts(s)
    check(n_cross > 0, f"sheet-soup contacts after the window: {n_cross} of {n_all}")
    check(all(launches["7"][n] > 0 for n in mixed_path),
          f"every kernel of the path launched: {launches['7']}")
    per_tick = {n: launches["7"][n] / 10 for n in mixed_path}
    print(f"  kernels: {sec * 1e3:.3f} ms/tick, {1.0 / sec:.2f} steps/s ({smi}; ticks"
          f" {first + 1}-{first + 10}; residual {s.last_residual:.6g};"
          f" {counts['cg_trips'] / 10:.1f} CG trips per tick; launches per tick {per_tick})")
    runs = []
    for plain in (False, True):
        w = clone_state(warm)
        c = pd.new_counters(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.tick_n(w, topo, params, cfg, 3, plain=plain, counters=c)
        torch.cuda.synchronize()
        runs.append((w, {k: int(v) for k, v in c.items()}, (time.perf_counter() - t0) / 3))
    check(not runs[0][0].failed() and not runs[1][0].failed(), "no sim_failed in either run")
    d = float((runs[0][0].positions[:n_live] - runs[1][0].positions[:n_live]).abs().max())
    check(d <= 1e-3 and runs[0][1] == runs[1][1],
          f"kernels and twins agree over 3 ticks from the warmed state: max |dx| {d:.3e},"
          f" counters {runs[0][1]}")
    print(f"  plain twins: {runs[1][2] * 1e3:.3f} ms/tick ({smi})")
    mixed_7 = (s, warm, first)  # phase 11c starts from the state of the first contact
    del s, st, topo, warm, runs, pos

    stamp("7")

    # ---- phases 5b and 6c
    def hold_loose(solver, fold_from):
        """T14 and T15 against their twins at a pure-loose scene's shapes, on
        the state as the run left it and on that state folded over itself:
        the nodes past the ``fold_from`` quantile of x mirrored back onto
        the part beside them, shifted off the lattice, each a seeded
        distance of at most min(threshold, 0.2 cells) above or under where
        it lands, before and now independently, so that points end within
        the threshold of a face (contacts) and points cross faces (the
        cubic).  Every cache field, latch, rebuild flag and contact list
        must be equal, with contacts and crossing combos present."""
        st, topo, params = solver.state, solver.topology, solver.current_params()
        lay = broadphase.super_layout(solver.config, topo.super_corners, topo.super_adj)
        sc = broadphase.scalars(params)
        failed, corners, adj = st.sim_failed, topo.super_corners, topo.super_adj
        live = st.node_mask > 0
        xs = st.positions[:, 0]
        edge = float(torch.quantile(xs[live][:: max(1, int(live.sum()) // 100_000)], fold_from))
        over = live & (xs > edge)
        amp = min(sc.thr, 0.2 * sc.cell)
        rng = np.random.default_rng(5)
        lift = torch.from_numpy(rng.uniform(-amp, amp, (2, st.capacity)).astype(np.float32)
                                ).to(dev) * over
        flat = st.positions.clone()
        flat[:, 0] = torch.where(over, 2.0 * edge - xs + 0.13 * sc.cell, xs)
        flat[:, 2] += 0.07 * sc.cell * over
        folded = []
        for dy in lift:
            f = flat.clone()
            f[:, 1] += dy
            folded.append(f)
        def detect(bf, nf, x, prev, force, bf_kw, nf_kw):
            c, ov = st.bp.clone(), zero()
            if force:
                c.fresh.zero_()
            rb = bf(x, prev, corners, adj, c, lay, sc, ov, failed, **bf_kw)
            wide = int(ov[0])  # T14's latch alone
            contacts = nf(x, prev, corners, c, lay, sc, ov, failed, **nf_kw)
            torch.cuda.synchronize()
            return c, int(rb[0]), wide, contacts, int(ov[0])

        for name, x, prev, force in (("as found", st.positions, st.prev_positions, False),
                                     ("folded", folded[0], folded[1], True)):
            flags, stats = [], {}
            ck, rbk, wide_k, pk, ovk = detect(broadphase.super_broadphase,
                                              broadphase.super_narrowphase, x, prev, force,
                                              dict(flags_out=flags), {})
            cp, rbp, wide_p, pp, ovp = detect(broadphase.super_broadphase_plain,
                                              broadphase.super_narrowphase_plain, x, prev,
                                              force, {}, dict(stats=stats))
            named = dict(zip(broadphase.SUPER_FLAGS, flags[0].tolist())) if flags else {}
            check(all(torch.equal(getattr(ck, f), getattr(cp, f)) for f in cache_fields)
                  and rbk == rbp and wide_k == wide_p,
                  f"T14 at {lay.live_k} loose rows, {name}: cache, latch and rebuild flag equal"
                  f" (rebuilt {rbk}, latch {wide_k}, valid pairs {int(ck.valid.sum())}, most"
                  f" per row {int(ck.valid.sum(1).max())}, flags {named})")
            check(all(torch.equal(a, b) for a, b in zip(pk, pp)) and ovk == ovp,
                  f"T15 at {lay.lanes} lanes, {name}: contacts equal ({int(pk[2][0])} contacts"
                  f" of at most {lay.cap}, latch {ovk}, {stats})")
        check(rbk == 1 and int(ck.valid.sum()) > 0 and int(pk[2][0]) > 0
              and stats["cross_combos"] > 0,
              f"the folded state has pairs, contacts and crossing combos"
              f" ({int(over.sum())} nodes folded at x > {edge:.3f})")
        x, prev = folded
        timing = st.bp.clone()

        def rebuild():
            timing.fresh.zero_()
            broadphase.super_broadphase(x, prev, corners, adj, timing, lay, sc, zero(), failed)

        ms14 = cuda_ms(rebuild, 10)
        ms15 = cuda_ms(lambda: broadphase.super_narrowphase(x, prev, corners, ck, lay, sc,
                                                            zero(), failed), 10)
        print(f"  on the folded state: T14 rebuild {ms14:.4f} ms, T15 {ms15:.4f} ms ({smi})")
        return x, prev, pk

    loose_path = [n for n in mixed_path if n != "constraint_rows"]
    print(f"phase 5b: the mesh of phase 5 with self-contact on, {mesh_warmup + 10} ticks")
    t0 = time.perf_counter()
    s = mesh_solver(pt, mesh_big, dev, collisions=True)
    lay = broadphase.super_layout(s.config, s.topology.super_corners, s.topology.super_adj)
    counts = pd.new_counters(dev)
    reset_launches()
    advance(s, mesh_warmup + 10, False, counts)
    launches["5b"] = read_launches()
    counts = {k: int(v) for k, v in counts.items()}
    print(f"  set-up and run {time.perf_counter() - t0:.2f} s: {lay.live_k} loose rows (W ="
          f" {lay.w}, {lay.n_face} face slot, {lay.a} neighbours per row at most); counters"
          f" {counts}")
    check(not s.sim_failed and lay.kp == 0, "a pure-loose layout, no sim_failed (no latch)")
    n_mesh = s._builder.num_nodes
    if counts["contacts"] == 0:
        check(torch.equal(s.state.positions[:n_mesh], mesh_off),
              "no contact: positions equal to the collisions-off run's (tolerance 0)")
    else:
        d = float((s.state.positions[:n_mesh] - mesh_off).abs().max())
        print(f"  {counts['contacts']} contacts: max |dx| against the collisions-off run {d:.3e}")
    check(all(launches["5b"][n] > 0 for n in loose_path),
          f"every kernel of the path launched: {launches['5b']}")
    xf, pf, _ = hold_loose(s, 0.75)
    print(f"phase 9b (on this folded state): T16 and T17 in the all-pairs and cell-list"
          f" branches, the super-body path switched off")
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    tris, tmask, failed = topo.triangles, topo.tri_mask, st.sim_failed
    no_super = dict(super_k=0, super_packed_k=0, super_packed_m=0, super_packed_off=0,
                    super_live_k=0, super_faces=(), super_packed_e=0, super_loose_face=-1)
    # Contact caps with room for the per-face repetition (15,844 contacts on
    # this state against T15's cap of 3,320) and for T15's pair buffer,
    # which drops crossing-only lanes past twice the cap.  The cell list with
    # the all-pairs width of 128 narrow slots and wider gathers: it drops a
    # bucket's entries past entries_cap and a row's past its raw budget
    # without a latch, as the JAX package does, so its contacts lie within
    # the exact (all-pairs) set.
    cap_t = 16 * cfg.budget.max_point_tri_contacts
    budget_t = dataclasses.replace(cfg.budget, max_point_tri_contacts=cap_t)
    tri_cfg = {"allpairs": dataclasses.replace(cfg, allpairs_broadphase_max=1 << 20,
                                               budget=budget_t, **no_super),
               "celllist": dataclasses.replace(
                   cfg, allpairs_broadphase_max=0, **no_super, budget=dataclasses.replace(
                       budget_t, max_narrow_candidates=128, max_entries_per_cell=64,
                       max_candidates_per_tri=broadphase.TRI_MAX_RAW))}
    # The reference: T14 and T15 on a fresh cache with zero slack.  The
    # all-pairs sweep tests every overlapping pair, so its set contains
    # theirs (equal on most states; on a small folded mesh it finds one
    # crossing contact more).
    fresh = broadphase.detect_point_tri_collisions(
        xf, pf, tmask, params, dataclasses.replace(cfg, budget=budget_t), failed=failed,
        corners=topo.super_corners, adj=topo.super_adj)[:3]
    held = {"allpairs": hold_tri("allpairs", xf, pf, tris, tmask, params, tri_cfg["allpairs"],
                                 failed, fresh, "T14 and T15 (fresh)", "contains")}
    held["celllist"] = hold_tri("celllist", xf, pf, tris, tmask, params, tri_cfg["celllist"],
                                failed, held["allpairs"][4], "the all-pairs branch", "within")
    for m in ("allpairs", "celllist"):
        ms16, ms16p, bytes16, ops16, ms17, ms17p, bytes17, ops17 = time_tri(
            m, xf, pf, tris, tmask, failed, held[m], st.capacity)
        if m == "allpairs":
            row("tri_candidates", "pies_tpu_torch/kernels/csrc/tri_candidates.cu",
                "pies_tpu/collision/broadphase.py:104", 0.0, ms16, ms16p, "equal", bytes16,
                ops16)
            row("tri_ccd", "pies_tpu_torch/kernels/csrc/tri_ccd.cu",
                "pies_tpu/collision/broadphase.py:1769", 0.0, ms17, ms17p, "equal", bytes17,
                ops17)
    # (phase 16c's cell-list and reference branches on this folded state)
    folded = clone_state(st)
    folded.positions.copy_(xf)
    folded.prev_positions.copy_(pf)
    keep["9b"]["mesh"] = (folded, topo, params, tri_cfg["celllist"], s._builder.num_nodes)
    del s, mesh_off, held, xf, pf, fresh, folded

    print(f"phase 6c: the rigged cloth of phase 6 with self-contact on, {cloth_first + 11} ticks")
    t0 = time.perf_counter()
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, device=dev)
    add_rigged_cloth(s, cloth_n, **CLOTH)
    lay = broadphase.super_layout(s.config, s.topology.super_corners, s.topology.super_adj)
    counts = pd.new_counters(dev)
    reset_launches()
    advance(s, cloth_first, False, counts)
    s.update_fixed_regions([fixed_region_matrix(cloth_n, CLOTH["scale"], CLOTH["height"],
                                                CLOTH_TURN)])
    advance(s, 11, False, counts)
    launches["6c"] = read_launches()
    counts = {k: int(v) for k, v in counts.items()}
    print(f"  set-up and run {time.perf_counter() - t0:.2f} s: {lay.live_k} loose rows,"
          f" {lay.lanes} lanes, {lay.a} neighbours per row at most; counters {counts}")
    check(not s.sim_failed and lay.kp == 0, "a pure-loose layout, no sim_failed (no latch)")
    n_cloth = s._builder.num_nodes
    if counts["contacts"] == 0:
        check(torch.equal(s.state.positions[:n_cloth], cloth_off),
              "no contact: positions equal to the collisions-off run's (tolerance 0)")
    else:
        d = float((s.state.positions[:n_cloth] - cloth_off).abs().max())
        print(f"  {counts['contacts']} contacts: max |dx| against the collisions-off run {d:.3e}")
    check(all(launches["6c"][n] > 0 for n in loose_path + ["constraint_rows", "shape_match"]),
          f"every kernel of the path launched: {launches['6c']}")
    hold_loose(s, 0.9)
    del s, cloth_off

    stamp("5b and 6c")

    # ---- phase 8
    print(f"phase 8: 40 ticks of a small mixed scene ({n_small} tets, a {small_sheet} x"
          f" {small_sheet} sheet at y = 2.2), kernels against twins")
    runs, per_tick = [], []
    for plain in (False, True):
        s = pt.Solver(pt.SolverOptions(solver=PD), device=dev, allpairs_broadphase_max=0)
        add_mixed_drape(s, n_small, small_sheet, sheet_y=2.2)
        counts = []
        for _ in range(40):
            c = pd.new_counters(dev)
            advance(s, 1, plain, c)
            counts.append(int(c["contacts"]))
        check(not s.sim_failed, f"no sim_failed (plain={plain})")
        runs.append(s.state.positions[: s._builder.num_nodes])
        per_tick.append(counts)
    check(per_tick[0] == per_tick[1] and sum(per_tick[0]) > 0,
          f"contact counts equal on every tick: {per_tick[0]}")
    d = float((runs[0] - runs[1]).abs().max())
    check(d <= 1e-3, f"trajectories agree: max |dx| {d:.3e}")

    stamp("8")

    # ---- phase 9 (a)
    tri_path = ["substep_head", "tri_candidates", "tri_ccd", "pt_coupling", "ell_matvec", "pcg",
                "pt_tail", "substep_tail"]

    from pies_tpu_torch.scene.contact_piles import add_box_pile, add_tet_boxes

    scenes9 = (
        ("cloth_pd_20x20", lambda s: s.create_sheet((0, 10, 0), 1.0, 1.0, 5000.0), {},
         ["constraint_rows"]),
        ("two_tet_boxes", add_tet_boxes, {}, ["tet_force_nodes"]),
        ("box_pile", add_box_pile, {}, ["constraint_rows"]),
        ("box_pile_reference", add_box_pile, dict(broadphase_mode="reference"),
         ["constraint_rows"]),
        ("cloth_pd_20x20_full", lambda s: s.create_sheet((0, 10, 0), 1.0, 1.0, 5000.0),
         dict(contact_coupling="full"), ["constraint_rows", "pt_full"]),
    )
    launches["9"] = {n: 0 for n in wrappers}
    for name, build, kw, extra in scenes9:
        runs = []
        for plain in (False, True):
            s = pt.Solver(pt.SolverOptions(solver=PD), device=dev, **kw)
            build(s)
            counts = []
            reset_launches()
            for _ in range(40):
                c = pd.new_counters(dev)
                advance(s, 1, plain, c)
                counts.append(int(c["contacts"]))
            runs.append((s, counts, s.sim_failed, read_launches()))
        (sk, ck, fk, lk), (sp, cp, fp, lp) = runs
        mode = broadphase.tri_mode(sk.config, sk.topology.tri_mask.shape[0])
        n = sk._builder.num_nodes
        d = float((sk.state.positions[:n] - sp.state.positions[:n]).abs().max())
        print(f"phase 9a: {name} ({n} nodes, {int(sk.topology.tri_mask.sum())} triangles, the"
              f" {mode} branch), 40 ticks, default Solver arguments{' ' if kw else ''}"
              f"{kw or ''}: contacts per tick {ck}")
        check(mode is not None and sk.config.enable_collisions, "self-contact on, a"
              " per-triangle branch")
        check(ck == cp and fk == fp and not fk, "kernels and twins: equal contact counts on"
              " every tick, no latch")
        check(d <= 1e-3, f"trajectories agree: max |dx| {d:.3e}")
        if not name.startswith("cloth_pd_20x20"):
            check(sum(ck) > 0, "contacts in the run")
        path = tri_path + extra
        check(all(lk[k] > 0 for k in path) and not any(lp.values()),
              f"every kernel of the path launched, the twins none: {lk}")
        for k in wrappers:
            launches["9"][k] += lk[k]
        reset_launches()
        sec, _ = window(sk, 10, False)
        per = {k: v / 10 for k, v in read_launches().items() if v}
        print(f"  kernels: {sec * 1e3:.3f} ms/tick, launches per tick {per} ({smi})")
        if name == "box_pile":
            keep["box_pile"] = sk  # phase 14d: T29's all-pairs branch
        del runs, sk, sp

    stamp("9")

    # ---- phase 10
    from pies_tpu_torch.scene.pbd_scenes import add_net, add_node_pile, add_rope_fleet

    PBD = pt.SolverName.PBD

    def pbd_solver(build, **kw):
        s = pt.Solver(pt.SolverOptions(solver=PBD), device=dev, **kw)
        build(s)
        s._prepare()
        return s

    def pbd_tick(s, plain, state=None):
        """One tick of the kernels (``run_ticks``) or of the twins on the card
        (on ``state`` when given, else the solver's); returns its device
        counters."""
        c = pbd.new_counters(dev)
        if plain:
            step.tick(state or s.state, s.topology, s.current_params(), s.config, plain=True,
                      counters=c)
        else:
            s.counters = c
            s.run_ticks(1)
            s.counters = None
        return {k: int(v) for k, v in c.items()}

    small_pbd = (
        ("net", add_net, dict(enable_collisions=False), "pbd_distance_seq"),
        ("box", lambda s: s.create_box((0.0, 3.0, 0.0), 1.0, 0.5), {}, "pbd_distance_seq"),
        ("tet_box_quirks", lambda s: s.create_tet_box((0.0, 3.0, 0.0), 1.0, (0, 0, 0), w=0.1,
                                                      mass=1.0), dict(enable_collisions=False),
         "pbd_constraints"),
        ("tet_box_fixed", lambda s: s.create_tet_box((0.0, 3.0, 0.0), 1.0, (0, 0, 0), w=0.1,
                                                     mass=1.0),
         dict(enable_collisions=False, reference_quirks=False), "pbd_constraints"),
        ("bend_sheet", lambda s: s.create_bend_sheet((0, 2.0, 0), 0.5, w=0.1),
         dict(enable_collisions=False), "pbd_constraints"))
    for name, build, kw, kernel in small_pbd:
        runs = []
        for plain in (False, True):
            s = pbd_solver(build, **kw)
            reset_launches()
            counts = [pbd_tick(s, plain) for _ in range(40)]
            runs.append((s, counts, s.sim_failed, read_launches()))
        (sk, ck, fk, lk), (sp, cp, fp, lp) = runs
        n = sk._builder.num_nodes
        d = float((sk.state.positions[:n] - sp.state.positions[:n]).abs().max())
        form = ("chains" if sk.config.distance_chain else
                f"{len(sk.config.distance_colors)} colour classes" if sk.config.distance_colors
                else "Jacobi")
        print(f"phase 10: {name} ({n} nodes, distance form {form}), 40 ticks, kernels against"
              f" twins: max |dx| {d:.3e}")
        check(ck == cp and fk == fp and not fk, "equal counters on every tick, no latch")
        check(d <= 1e-3, f"trajectories agree: max |dx| {d:.3e}")
        check(lk[kernel] > 0 and not any(lp.values()), f"{kernel} launched, the twins launch"
              f" nothing: {lk}")
        del runs, sk, sp

    def warm_to_contact(s, first, cap):
        """``first`` ticks, then tick by tick until a tick has floor-active nodes
        and touching pairs; returns the ticks run."""
        s.run_ticks(first)
        for t in range(cap):
            c = pbd_tick(s, False)
            if c["floor_active"] > 0 and c["touching"] > 0:
                return first + t + 1
        raise SystemExit(f"FAILED: no floor contact with touching pairs in {first + cap} ticks")

    cells = (("rope_pbd", add_rope_fleet, pbd_bench[0], 35),
             ("pbd_node_pile", add_node_pile, pbd_bench[1], 2),
             ("rope fleet", add_rope_fleet, pbd_big, 35),
             ("pile", add_node_pile, pbd_big, 2))
    warmed = {}
    for label, build, n_part, first in cells:
        t0 = time.perf_counter()
        s = pbd_solver(lambda s: build(s, n_part), enable_collisions=True)
        setup = time.perf_counter() - t0
        warm = warm_to_contact(s, first, 60)
        print(f"phase 10: {label}, {n_part} particles ({s.state.capacity} slots,"
              f" {'chains' if s.config.distance_chain else 'no distance constraints'}):"
              f" set-up {setup:.2f} s, contact at tick {warm}")
        # From the warmed state: 3 ticks of the kernels against 3 of the twins.
        sp = clone_state(s.state)
        ck = [pbd_tick(s, False) for _ in range(3)]
        cp = [pbd_tick(s, True, sp) for _ in range(3)]
        d = float((s.state.positions - sp.positions).abs().max())
        check(d <= 1e-3 and s.sim_failed == sp.failed() == False,  # noqa: E712
              f"3 ticks, kernels against twins: max |dx| {d:.3e}, no latch")
        check([(c["pairs"], c["rebuilds"]) for c in ck] == [(c["pairs"], c["rebuilds"]) for c in cp],
              f"pair counts and rebuilds equal on every tick: {ck}")
        del sp
        reset_launches()
        c = pbd.new_counters(dev)
        s.counters = c
        t0 = time.perf_counter()
        s.run_ticks(10)
        sec = (time.perf_counter() - t0) / 10
        s.counters = None
        counts = {k: int(v) for k, v in c.items()}
        lw = read_launches()
        check(counts["pairs"] > 0 and counts["touching"] > 0 and counts["floor_active"] > 0
              and not s.sim_failed and bool(torch.isfinite(s.state.positions).all()),
              f"a contact-active window: {counts}")
        per = {k: v / 10 for k, v in lw.items() if v}
        print(f"  kernels: {sec * 1e3:.3f} ms/tick, {1.0 / sec:.2f} steps/s ({smi}); per tick:"
              f" {counts['rebuilds'] / 10} rebuilds, {counts['pairs'] / 40:.1f} live and"
              f" {counts['touching'] / 40:.1f} touching pairs per iteration,"
              f" {counts['floor_active'] / 10:.1f} floor nodes; launches per tick {per}")
        check(lw["node_pairs"] > 0 and lw["node_response"] > 0 and lw["pbd_constraints"] > 0
              and (lw["pbd_distance_seq"] > 0 or build is add_node_pile),
              "every kernel of the path launched")
        launches["10 " + label] = lw
        if n_part == pbd_big:
            warmed[label] = s
        else:
            del s

    # T18-T21 against their twins at the full width, timed.
    fleet, pile_s = warmed["rope fleet"], warmed["pile"]
    n_big = fleet.state.capacity
    params_f, cfg_f, topo_f = fleet.current_params(), fleet.config, fleet.topology

    def t18(st, k):
        """One substep's T18 launches on the fleet: head, per iteration the
        pins' rows and application and the floor clamp, then the tail."""
        (pbd.substep_head if k else pbd.substep_head_plain)(st, params_f, False)
        for _ in range(cfg_f.iterations):
            rows_fn = proj.jacobi_rows if k else proj.jacobi_rows_plain
            vals = rows_fn("position", st.positions, st.inv_mass, topo_f.position,
                           w_scale=1.0, failed=st.sim_failed)
            (pbd.apply_jacobi if k else pbd.apply_jacobi_plain)(
                st.positions, topo_f.jacobi.position, vals, st.sim_failed)
            (pbd.floor_clamp if k else pbd.floor_clamp_plain)(
                st.positions, st.radius, st.node_mask, params_f.floor_height, st.sim_failed)
        (pbd.substep_tail if k else pbd.substep_tail_plain)(st, st.positions, params_f)

    a, b = clone_state(fleet.state), clone_state(fleet.state)
    t18(a, True)
    t18(b, False)
    err18 = float((a.positions - b.positions).abs().max())
    check(err18 == 0.0 and torch.equal(a.velocities, b.velocities),
          "T18 (head, pins, floor, tail) equals its twin on the fleet")
    n_pins = int(topo_f.position.idx.shape[0])
    vals = proj.jacobi_rows_plain("position", a.positions, a.inv_mass, topo_f.position)
    pin_idx = topo_f.position.idx.long()
    row("pbd_constraints", "pies_tpu_torch/kernels/csrc/pbd_constraints.cu",
        "pies_tpu/solver/pbd.py:32", err18, cuda_ms(lambda: t18(a, True), 20),
        cuda_ms(lambda: t18(b, False), 3), "equal",
        72 * n_big + 36 * n_pins, 40 * n_big + cfg_f.iterations * 10 * n_pins,
        cuda_ms(lambda: torch.zeros((n_big, 4), device=dev).index_add_(0, pin_idx, vals), 20))
    ch = topo_f.chains
    xk, xp = fleet.state.positions.clone(), fleet.state.positions.clone()
    pbd.chain_scan(xk, ch, fleet.state.sim_failed)
    pbd.chain_scan_plain(xp, ch)
    err19 = float((xk - xp).abs().max())
    check(err19 == 0.0, f"T19 chain walk equals its twin ({ch.idx0.shape[0]} chains of"
          f" {ch.idx0.shape[1]} links)")
    links = ch.idx0.numel()
    row("pbd_distance_seq", "pies_tpu_torch/kernels/csrc/pbd_distance_seq.cu",
        "pies_tpu/solver/pbd.py:91", err19,
        cuda_ms(lambda: pbd.chain_scan(xk, ch, fleet.state.sim_failed), 20),
        cuda_ms(lambda: pbd.chain_scan_plain(xp, ch), 3), "equal",
        36 * links + 16 * ch.idx0.shape[0], 45 * links)
    st = pile_s.state
    params_p, cfg_p = pile_s.current_params(), pile_s.config
    n_pile = st.capacity
    ck, cp = st.nn.clone(), st.nn.clone()
    for cc in (ck, cp):
        cc.fresh.zero_()
    args = (st.positions, st.radius, st.node_mask)
    broadphase.node_pairs(*args, ck, params_p, cfg_p, st.sim_failed)
    broadphase.node_pairs_plain(*args, cp, params_p, cfg_p, st.sim_failed)
    pairs = int(cp.count[0])
    same = int(ck.count[0]) == pairs and all(
        torch.equal(getattr(ck, f)[:pairs], getattr(cp, f)[:pairs]) for f in ("pi", "pj", "inc_pair")
    ) and all(torch.equal(getattr(ck, f), getattr(cp, f)) for f in ("row_off", "inc_start", "ref"))
    check(same, f"T20 rebuild equals its twin: {pairs} pairs, prefix, ref and incidence")

    def rebuild20(fn, cc):
        cc.fresh.zero_()
        fn(*args, cc, params_p, cfg_p, st.sim_failed)

    ms_keep = cuda_ms(lambda: broadphase.node_pairs(*args, ck, params_p, cfg_p, st.sim_failed), 20)
    row("node_pairs", "pies_tpu_torch/kernels/csrc/node_pairs.cu",
        "pies_tpu/collision/broadphase.py:1903", 0.0,
        cuda_ms(lambda: rebuild20(broadphase.node_pairs, ck), 20),
        cuda_ms(lambda: rebuild20(broadphase.node_pairs_plain, cp), 3), "equal",
        52 * n_pile + 12 * pairs, 0)
    print(f"  node_pairs without a rebuild (the drift test): {ms_keep:.4f} ms")
    vel = st.velocities
    out_k = broadphase.node_response(st.positions, vel, st.radius, st.inv_mass, st.node_mask, ck,
                                     params_p, st.sim_failed)
    out_p = broadphase.node_response_plain(st.positions, vel, st.radius, st.inv_mass,
                                           st.node_mask, cp, params_p, st.sim_failed)
    err21 = max(float((out_k[0] - out_p[0]).abs().max()), float((out_k[1] - out_p[1]).abs().max()))
    check(err21 == 0.0 and int(out_k[2][0]) == int(out_p[2][0]) > 0,
          f"T21 equals its twin: {int(out_k[2][0])} touching of {pairs} pairs")
    vi, vj, _ = broadphase.pair_terms(st.positions, vel, st.radius, st.inv_mass, cp.pi[:pairs],
                                      cp.pj[:pairs], params_p)
    rows21 = torch.cat([cp.pi[:pairs], cp.pj[:pairs]]).long()
    vals21 = torch.cat([vi, vj])
    row("node_response", "pies_tpu_torch/kernels/csrc/node_response.cu",
        "pies_tpu/collision/broadphase.py:2035", err21,
        cuda_ms(lambda: broadphase.node_response(st.positions, vel, st.radius, st.inv_mass,
                                                 st.node_mask, ck, params_p, st.sim_failed), 20),
        cuda_ms(lambda: broadphase.node_response_plain(st.positions, vel, st.radius,
                                                       st.inv_mass, st.node_mask, cp, params_p,
                                                       st.sim_failed), 3), "equal",
        68 * n_pile + 12 * pairs, 140 * pairs,
        cuda_ms(lambda: torch.zeros((n_pile, 6), device=dev).index_add_(0, rows21, vals21), 20))
    del warmed, fleet, pile_s, a, b, xk, xp, ck, cp

    stamp("10")

    # ---- phase 11: full contact coupling, the block preconditioner and the
    # entry-list floor (T22-T24)
    def generic_inputs(solver):
        """The generic path's substep inputs on a copy of ``solver``'s state
        (twins): predicted positions, inertia term, diagonal (with the
        contacts'), floor weight (the operator's dense diagonal under full
        coupling), the entry-list floor, and the contacts with T7's
        incidence for full coupling."""
        c = clone_state(solver.state)
        tp, cf, pr = solver.topology, solver.config, solver.current_params()
        x, msn, diag, wf, active = pd.substep_head_plain(c, tp, pr, cf, True)
        floor = None
        if not cf.dense_floor:
            wf, floor = pd.floor_entries_plain(x, tp, pr, cf, diag)
        colls = full = None
        if cf.enable_collisions:  # (phase 11 asks under full coupling only)
            colls = pd.detect_point_tri(c, x, tp, pr, cf, active, plain=True)
            _, hh = pd._h_h2(pr)
            inc, _ = tetcols.pt_coupling_setup_plain(colls, c.mass, tp, hh, diag, wf)
            full = assembly.FullCoupling(colls, inc, pr.collision_thickness)
        return c, x, msn, diag, wf, floor, colls, full

    def kernels_vs_twins(solver, warm_state, ticks=3):
        """``ticks`` ticks of the kernels against the twins from
        ``warm_state``: max |dx| and the two runs' counters."""
        runs = []
        for plain in (False, True):
            w = clone_state(warm_state)
            c = pd.new_counters(dev)
            step.tick_n(w, solver.topology, solver.current_params(), solver.config, ticks,
                        plain=plain, counters=c)
            torch.cuda.synchronize()
            runs.append((w, {k: int(v) for k, v in c.items()}))
        check(not runs[0][0].failed() and not runs[1][0].failed(), "no sim_failed in either run")
        d = float((runs[0][0].positions - runs[1][0].positions).abs().max())
        check(d <= 1e-3 and runs[0][1] == runs[1][1],
              f"{ticks} ticks, kernels against twins: max |dx| {d:.3e}, counters {runs[0][1]}")

    def timed_window(label, solver, names, first_tick):
        """``run_ticks(10)`` with the launch counts reset before; checks the
        window's gates and prints ms/tick, CG trips per solve and launches."""
        reset_launches()
        sec, counts = window(solver, 10, False)
        launches[label] = read_launches()
        pos = solver.state.positions[: solver._builder.num_nodes]
        check(not solver.sim_failed and bool(torch.isfinite(pos).all()),
              "no sim_failed, all positions finite")
        check(counts["floor_active"] > 0,
              f"floor contact in the window: {counts['floor_active']} node-substeps")
        if solver.config.enable_collisions:
            check(counts["contacts"] > 0,
                  f"contacts in the window: {counts['contacts'] / 10:.1f} per tick")
        check(all(launches[label][n] > 0 for n in names),
              f"every kernel of the path launched: {launches[label]}")
        cf = solver.config
        solves = 10 * cf.time_substeps * cf.iterations
        per_tick = {n: launches[label][n] / 10 for n in names}
        print(f"  kernels: {sec * 1e3:.3f} ms/tick, {1.0 / sec:.2f} steps/s ({smi}; ticks"
              f" {first_tick}-{first_tick + 9}; {counts['cg_trips'] / solves:.2f} CG trips per"
              f" solve; counters {counts}; launches per tick {per_tick})")
        return counts, solves

    generic_soup = ["substep_head", "body_broadphase", "pt_narrowphase", "pt_coupling",
                    "tet_force_nodes", "ell_matvec", "pcg", "tet_block", "pt_tail",
                    "substep_tail"]

    # 11a: the bench soup under full contact coupling.
    print(f"phase 11a: the soup, {4 * soup_tets} particles, contact_coupling='full',"
          f" {CONTACT_WARMUP} warm-up ticks")
    t0 = time.perf_counter()
    s = pt.Solver(pt.SolverOptions(solver=PD), enable_collisions=True, contact_coupling="full",
                  device=dev)
    s.create_tet_soup(soup_tets, **SCENE)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    check(not tetcols.applies(st, topo, cfg) and pd.block_layout(st, topo)
          and topo.ell_nbr.shape[0] == 0 and topo.tet_band is not None,
          f"the generic path with the block preconditioner, the band and an ELL of width 0"
          f" (set-up {time.perf_counter() - t0:.2f} s)")
    advance(s, CONTACT_WARMUP, False)
    warm = clone_state(s.state)
    counts, solves = timed_window("11a", s, generic_soup + ["pt_full"], CONTACT_WARMUP + 1)
    trips_11a = counts["cg_trips"] / solves
    kernels_vs_twins(s, warm)

    print("phase 11a: T22 and T23 against their twins on the warmed soup")
    s._state = warm
    c, x, msn, diag, wf, _, colls, full = generic_inputs(s)
    st, failed = s.state, s.state.sim_failed
    _, h2 = pd._h_h2(params)
    n_nodes, k_blocks, live = st.capacity, st.capacity // 4, int(colls.pt_count[0])
    check(live > 0, f"{live} live contacts at tick {CONTACT_WARMUP + 1}")
    fk = assembly.tet_block_factor(diag, topo.tet_block6, failed)
    fp = assembly.tet_block_factor_plain(diag, topo.tet_block6)
    torch.cuda.synchronize()
    check(torch.equal(fk, fp), f"T22 factor of {k_blocks} blocks equals its twin")
    blocks44 = torch.zeros((k_blocks, 4, 4), device=dev)
    dview = diag.view(k_blocks, 4)
    for a in range(4):
        blocks44[:, a, a] = dview[:, a]
    for r_, (a, b) in enumerate(((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))):
        blocks44[:, a, b] = blocks44[:, b, a] = topo.tet_block6[r_]
    rhs = x.view(k_blocks, 4, 3)
    row("tet_block", "pies_tpu_torch/kernels/csrc/tet_block.cu",
        "pies_tpu/solver/assembly.py:602", 0.0,
        cuda_ms(lambda: assembly.tet_block_factor(diag, topo.tet_block6, failed), 50),
        cuda_ms(lambda: assembly.tet_block_factor_plain(diag, topo.tet_block6), 10), "equal",
        80 * k_blocks, 40 * k_blocks,
        cuda_ms(lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky(blocks44)), 10))
    yk, pk = assembly.apply_system(x, st.mass, wf, h2, topo, failed, part=True, full=full)
    yp, pp = assembly.apply_system_plain(x, st.mass, wf, h2, topo, part=True, full=full)
    bare, _ = assembly.apply_system_plain(x, st.mass, wf, h2, topo)
    torch.cuda.synchronize()
    n_ent = int(full.inc.row_start[-1])
    err23 = float((yk - yp).abs().max())
    check(torch.equal(yk, yp) and torch.equal(pk, pp) and not torch.equal(yk, bare),
          f"T23 in T10 (the contacts' blocks beside the band, {live} contacts, {n_ent}"
          f" entries): product and partials equal; the blocks move it by"
          f" {float((yk - bare).abs().max()):.4g}")
    ent_nodes = full.inc.nodes[:n_ent].long()
    ent_rows = torch.randn((n_ent, 3), device=dev)
    y_t, p_t = torch.empty_like(yk), torch.empty_like(pk)
    ms_bare = cuda_ms(lambda: assembly.apply_system(x, st.mass, wf, h2, topo, failed,
                                                    part=p_t, out=y_t), 50)
    row("pt_full", "pies_tpu_torch/kernels/csrc/pt_full.cuh",
        "pies_tpu/solver/assembly.py:559", err23,
        cuda_ms(lambda: assembly.apply_system(x, st.mass, wf, h2, topo, failed, part=p_t,
                                              out=y_t, full=full), 50),
        cuda_ms(lambda: assembly.apply_system_plain(x, st.mass, wf, h2, topo, part=True,
                                                    full=full), 5), "equal",
        64 * n_nodes + 8 * n_ent + 64 * live, 54 * n_nodes + 30 * n_ent,
        cuda_ms(lambda: torch.zeros((n_nodes, 3), device=dev).index_add_(0, ent_nodes,
                                                                         ent_rows), 50))
    print(f"  T10 without the contact term on this state: {ms_bare:.4f} ms")
    rows_k = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats.clone(), topo,
                                 cfg.rotation_iterations, failed)
    plane = pd.floor_plane(params, cfg.reference_quirks)
    ak = assembly.assemble_force(x, msn, wf, rows_k, topo, plane, failed, None, full)
    ap = assembly.assemble_force_plain(x, msn, wf, rows_k, topo, plane, None, None, full)
    torch.cuda.synchronize()
    check(torch.equal(ak[0], ap[0]) and torch.equal(ak[1], ap[1]),
          "T23 in T9 stage 2 (the stacked contact force): force and static projection equal")
    cg_args = (ak[0], x, diag, st.mass, wf, h2, st.node_mask, topo, cfg.cg_iterations,
               cfg.cg_rtol, failed, fk, full)
    ok = assembly.pcg_solve(*cg_args)
    op = assembly.pcg_solve_plain(*cg_args)
    torch.cuda.synchronize()
    check(torch.equal(ok[0], op[0]) and torch.equal(ok[1], op[1])
          and torch.equal(ok[2], op[2]),
          f"T11 with the block solve and T23's operator: solution, residual partials and"
          f" trips equal ({int(ok[2][0])} trips of {cfg.cg_iterations})")
    print(f"  T11 a whole solve on this state: kernel"
          f" {cuda_ms(lambda: assembly.pcg_solve(*cg_args), 20):.4f} ms")
    del s, st, warm, c, x, msn, diag, wf, colls, full, yk, yp, bare, rows_k, ak, ap, ok, op
    del blocks44, rhs

    # 11b: the soup of phase 3b off the tet-column path (recentered coupling).
    s = soup_3b
    ticks_3b = CONTACT_WARMUP + 10
    print(f"phase 11b: the soup of phase 3b at tick {ticks_3b}, tet_cols=False")
    shared = clone_state(s.state)
    cols_cfg = s.config
    a, b = clone_state(shared), clone_state(shared)
    step.tick(a, s.topology, s.current_params(), cols_cfg)
    gen_cfg = dataclasses.replace(cols_cfg, tet_cols=False)
    check(not tetcols.applies(s.state, s.topology, gen_cfg) and pd.block_layout(s.state, s.topology),
          "tet_cols=False: the generic path with the block preconditioner")
    step.tick(b, s.topology, s.current_params(), gen_cfg)
    torch.cuda.synchronize()
    d = float((a.positions - b.positions).abs().max())
    # The tolerance: the tet-column tick's own float32 spread on this state,
    # the farthest it moves from ticks started one ulp away (half the
    # coordinates moved up or down, four seeds), times 2: a contact on the
    # knife edge of a friction or push-out test jumps in either path.  (The
    # JAX package bounds its two paths' gap by 2e-4 over 8 ticks of a 24-tet
    # soup whose coordinates stay within ~3, tests/test_fastpaths.py:100;
    # this soup's reach 40 and more, and a float32 ulp grows with them.)
    spread = 0.0
    gen = torch.Generator(device=dev)
    for seed in range(4):
        gen.manual_seed(seed)
        c = clone_state(shared)
        moved = torch.rand(c.positions.shape, generator=gen, device=dev) < 0.5
        up = torch.rand(c.positions.shape, generator=gen, device=dev) < 0.5
        away = torch.nextafter(c.positions, torch.where(up, float("inf"), float("-inf")))
        live_rows = c.node_mask[:, None] > 0
        c.positions.copy_(torch.where(moved & live_rows, away, c.positions))
        step.tick(c, s.topology, s.current_params(), cols_cfg)
        torch.cuda.synchronize()
        spread = max(spread, float((c.positions - a.positions).abs().max()))
    check(d <= 2.0 * spread, f"one tick from one state: the generic path within 2x the"
          f" tet-column path's own one-ulp spread {spread:.3e} of its tick (max |dx| {d:.3e})")
    s._config = gen_cfg
    counts, solves = timed_window("11b", s, generic_soup, ticks_3b + 1)
    check(counts["cg_trips"] == solves, f"one CG trip per solve ({counts['cg_trips']} trips in"
          f" {solves} solves): the block preconditioner is exact")
    kernels_vs_twins(s, shared)
    keep["soup"] = s  # phase 14d: T29's packed-body branch
    del soup_3b, s, shared, a, b

    # 11c: the sheet over the soup of phase 7, from its first sheet-soup
    # contact, under full coupling.
    s, warm, first = mixed_7
    print(f"phase 11c: the cloth over the soup of phase 7 from tick {first},"
          f" contact_coupling='full'")
    s._state = clone_state(warm)
    s._config = dataclasses.replace(s.config, contact_coupling="full")
    timed_window("11c", s, mixed_path + ["pt_full"], first + 1)
    kernels_vs_twins(s, warm)
    del mixed_7, s, warm

    # 11d: the mesh of phase 5 on the entry-list floor.
    s, warm = mesh_5
    print(f"phase 11d: the mesh of phase 5 from tick {mesh_warmup}, dense_floor=False")
    dense_cfg = s.config
    entry_cfg = dataclasses.replace(dense_cfg, dense_floor=False)
    s._config = entry_cfg
    c, x, msn, diag, wf, floor, _, _ = generic_inputs(s)
    st, topo, params = s.state, s.topology, s.current_params()
    failed, n_nodes = st.sim_failed, st.capacity
    dk, dp = diag.clone(), diag.clone()
    wk, flk = pd.floor_entries(x, topo, params, entry_cfg, dk, failed)
    wp, flp = pd.floor_entries_plain(x, topo, params, entry_cfg, dp)
    torch.cuda.synchronize()
    n_entries, live_e = topo.corner_inc.cap, int(flp.static_mask.sum())
    check(torch.equal(dk, dp) and torch.equal(wk, wp)
          and all(torch.equal(getattr(flk, f), getattr(flp, f))
                  for f in ("static_mask", "floor_active", "floor_counts")),
          f"T24 at {n_entries} entries ({live_e} live, {int(flp.floor_active.sum())} nodes):"
          " masks, weights, counts, snap flags and diagonal equal")
    ent_nodes = topo.corner_inc.nodes.long()
    ent_w = torch.ones((n_entries, 1), device=dev)
    row("floor_entries", "pies_tpu_torch/kernels/csrc/floor_entries.cu",
        "pies_tpu/collision/batches.py:104", 0.0,
        cuda_ms(lambda: pd.floor_entries(x, topo, params, entry_cfg, diag.clone(), failed), 50),
        cuda_ms(lambda: pd.floor_entries_plain(x, topo, params, entry_cfg, diag.clone()), 5),
        "equal", 36 * n_nodes + 12 * n_entries, 4 * n_entries,
        cuda_ms(lambda: torch.zeros((n_nodes, 1), device=dev).index_add_(0, ent_nodes, ent_w),
                50))
    rows_k = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats.clone(), topo,
                                 entry_cfg.rotation_iterations, failed)
    plane = pd.floor_plane(params, entry_cfg.reference_quirks)
    ak = assembly.assemble_force(x, msn, wk, rows_k, topo, plane, failed, floor=flk)
    ap = assembly.assemble_force_plain(x, msn, wp, rows_k, topo, plane, floor=flp)
    torch.cuda.synchronize()
    check(torch.equal(ak[0], ap[0]) and torch.equal(ak[1], ap[1]),
          "T9 stage 2 with the entry-list floor: force and static projection equal")
    tk, tp_ = clone_state(warm), clone_state(warm)
    pd.substep_tail(tk, topo, params, flk.floor_active, x, ak[1], floor_counts=flk.floor_counts)
    pd.substep_tail_plain(tp_, topo, params, flp.floor_active, x, ak[1],
                          floor_counts=flp.floor_counts)
    torch.cuda.synchronize()
    check(all(torch.equal(getattr(tk, f), getattr(tp_, f))
              for f in ("positions", "prev_positions", "velocities", "forces", "sim_failed")),
          "T4 with the entry list's counts equals its twin")
    del c, rows_k, ak, ap, tk, tp_
    # Per tick against the dense floor from the same state.  The entry
    # list's k additions of w*p round otherwise than the dense (k w)*p, a
    # last-bit change of the force; the gate is 1e-6 of the position scale
    # or, where the dense tick's own float32 spread is larger, twice that
    # spread (its farthest move from a state one ulp away, one seed per
    # tick).  With the CG's early exit off (16 trips, both floors) the gap
    # is printed too: the exit test can end a solve a trip apart.
    scale = float(warm.positions[: s._builder.num_nodes].abs().max())
    s._state = clone_state(warm)
    worst = worst_fixed = spread = 0.0
    fixed = lambda cf: dataclasses.replace(cf, cg_rtol=0.0)  # noqa: E731
    gen = torch.Generator(device=dev)
    for k in range(10):
        runs = []
        for cf in (entry_cfg, fixed(entry_cfg), fixed(dense_cfg)):
            e = clone_state(s.state)
            step.tick(e, topo, params, cf)
            runs.append(e.positions)
        gen.manual_seed(k)
        u = clone_state(s.state)
        moved = (torch.rand(u.positions.shape, generator=gen, device=dev) < 0.5) \
            & (u.node_mask[:, None] > 0)
        up = torch.rand(u.positions.shape, generator=gen, device=dev) < 0.5
        u.positions.copy_(torch.where(moved, torch.nextafter(
            u.positions, torch.where(up, float("inf"), float("-inf"))), u.positions))
        step.tick(u, topo, params, dense_cfg)
        step.tick(s.state, topo, params, dense_cfg)
        worst = max(worst, float((runs[0] - s.state.positions).abs().max()))
        worst_fixed = max(worst_fixed, float((runs[1] - runs[2]).abs().max()))
        spread = max(spread, float((u.positions - s.state.positions).abs().max()))
    tol = max(1e-6 * scale, 2.0 * spread)
    check(worst <= tol, f"one tick from each state of ticks {mesh_warmup + 1}-"
          f"{mesh_warmup + 10}: the entry-list floor within {tol:.3e} of the dense floor"
          f" (max |dx| {worst:.3e}, {worst / scale:.2e} of the position scale {scale:.3f};"
          f" the dense tick's one-ulp spread {spread:.3e}; with 16 fixed CG trips the"
          f" floors part by {worst_fixed:.3e})")
    s._state = clone_state(warm)
    s._config = entry_cfg
    timed_window("11d", s, ["substep_head", "floor_entries", "tet_force_nodes", "ell_matvec",
                            "pcg", "substep_tail"], mesh_warmup + 1)
    kernels_vs_twins(s, warm)
    print(f"  phase 11a: {trips_11a:.2f} CG trips per solve under full coupling")
    del mesh_5, s, warm

    stamp("11")

    # ---- phase 12: edge-edge and PD node-node contacts (T25-T27)
    nets12b = phase12(pt, dev, smi, PD, row, launches, reset_launches, read_launches,
                      kernels_vs_twins, nets_nn, nets_big, cloud_n)

    stamp("12")

    # ---- phase 13: the scene ensemble (T1-T8 with a member axis)
    ens13 = phase13(pt, dev, smi, PD, rows, launches, reset_launches, read_launches,
                    main_path, ens_members, ens_tets, ens_small)

    stamp("13")

    # ---- phase 14: the mesher, add_tri_mesh_volume and the diagnostics (T28, T29)
    nine_b = keep.pop("9b")  # (phase 14 clears the rest; phase 16c reads these)
    phase14(pt, dev, smi, PD, row, launches, reset_launches, read_launches, keep,
            mesh_res, mesh_scale, mesh_dump)

    stamp("14")

    # ---- phase 15: ensembles on the contact-free generic path (T3, T9-T13,
    # T22, T4 with a member axis)
    phase15(pt, dev, smi, PD, rows, launches, reset_launches, read_launches, generic, ens_drop,
            ens_rope, drop_res, ens_cloth, ens_block)

    stamp("15")

    # ---- phase 16: ensembles on the generic path with point-triangle
    # self-contact (T14-T17, T7, T8, T23, T24 with a member axis)
    phase16(pt, dev, smi, PD, rows, launches, reset_launches, read_launches, nine_b,
            ens_contacts, ens_pile, contact_res, pile_boxes)

    stamp("16")

    # ---- phase 17: ensembles on the generic path with edge-edge and node-node
    # contacts (T20, T25-T27 with a member axis)
    phase17(pt, dev, smi, PD, rows, launches, reset_launches, read_launches, nets12b, ens_nets,
            nets_nn, ens_cloud, ens_big)
    del nets12b

    stamp("17")

    # ---- phase 18: PBD ensembles (T18, T19, T21 with a member axis, T20's
    # node-pair cache per member across ticks)
    phase18(pt, dev, smi, rows, launches, reset_launches, read_launches, ens_pbd, pbd_bench,
            ens_tets)
    stamp("18")

    # ---- phase 19: tet-column ensembles with self-contact off the packed
    # bodies (the reference sweep and the cell list, ROADMAP item 10c)
    phase19(pt, dev, smi, PD, rows, launches, reset_launches, read_launches, ens_members,
            ens_tets)
    stamp("19")

    # ---- phase 20: the domain decomposition on one card (T30; T3, T4,
    # T9-T13, T16/T17, T20, T25-T27 over the slabs)
    keep21 = {}
    phase20(pt, dev, smi, PD, row, rows, launches, reset_launches, read_launches, domain_keep,
            cloud_n, nets_nn, domain_small, domain_slabs, keep21)
    stamp("20")

    # ---- phase 21: the domain decomposition and the ensembles across
    # torch.distributed ranks (T30's outer bands, T11's split partials)
    phase21(pt, dev, smi, row, rows, ens13, keep21)
    del ens13, keep21
    stamp("21")

    table = []
    generic_ens = ("substep_head", "substep_tail", "tet_force_nodes", "ell_matvec", "pcg",
                   "constraint_rows", "shape_match", "tet_block")
    mixed_rows = {"super_broadphase": "super_broadphase",
                  "super_narrowphase": "super_narrowphase",
                  "assemble_force_contacts": "tet_force_nodes", "ell_matvec_band": "ell_matvec"}
    for name, r in rows.items():
        if name in RANK_ROWS:
            pass  # (phase 21 set them from rank 0's window on phase 20a's mesh)
        elif name in mixed_rows:
            r["launches"] = launches["7"][mixed_rows[name]]
        elif name == T2_CONTACT:
            # Every T2 call of 3b is a contact substep with T7's force
            # inside (3b checks it); the ensemble's (13) beside it.
            r["launches"] = launches["3b"]["tet_cols_substep"]
            r["launches_by_path"] = {p: launches[p]["tet_cols_substep"] for p in ("3b", "13")}
        elif name in ("tet_block", "pt_full", "floor_entries"):
            # The main path of each: 11a (T22, T23) and 11d (T24); every
            # phase-11 window beside it.
            r["launches"] = launches["11d" if name == "floor_entries" else "11a"][name]
            paths = ("11a", "11b", "11c", "11d") + (("6b",) if name == "tet_block" else ())
            r["launches_by_path"] = {p: launches[p][name] for p in paths}
        elif name in ("tri_candidates", "tri_ccd"):
            r["launches"] = launches["9"][name]
        elif "timed_on" in r:
            # A domain mode of an earlier slice's kernel (its emit mask, its
            # accumulate-only mode): the window of the scene it was timed on,
            # every domain scene beside it.
            base = name.split(" (")[0]
            r["launches"] = launches[r.pop("timed_on")][base]
            r["launches_by_path"] = {p: launches[p][base] for p in DOMAIN_PATHS}
        elif name.startswith("halo_"):
            # T30's main path: the mesh in 8 slabs (20a), the soup's contact
            # lists (20b); every domain scene beside it.
            r["launches"] = launches["20b" if name == "halo_merge" else "20a"][name]
            r["launches_by_path"] = {p: launches[p][name] for p in DOMAIN_PATHS}
        elif name in ("residuals", "occupancy"):
            # The main path: 14a's window and the diagnostics read after it;
            # 14b's beside it.
            r["launches"] = launches["14a"][name]
            r["launches_by_path"] = {p: launches[p][name] for p in ("14a", "14b")}
        elif name in ("edge_ccd", "edge_terms", "node_contacts"):
            # The main path of each: 12b (the nets at full width: T25, T26)
            # and 12c (the node cloud: T27); every phase-12 window beside it.
            r["launches"] = launches["12c" if name == "node_contacts" else "12b"][name]
            r["launches_by_path"] = {p: launches[p][name] for p in ("12a", "12b", "12c")}
        elif name in PBD_ROWS:
            # The 10-tick window of the cell the row was timed on, and each
            # cell's own window beside it.
            timed = "rope fleet" if name in PBD_ROWS[:2] else "pile"
            r["launches"] = launches["10 " + timed][name]
            r["launches_by_path"] = {c[0]: launches["10 " + c[0]][name] for c in cells}
            # The PBD ensembles (18a-18c, B = 64), where they reach the kernel.
            r["launches_by_path"].update({p: launches[p][name] for p in PBD_PATHS
                                          if launches[p][name]})
        elif name.endswith("_cloth") or name in ("constraint_rows", "shape_match"):
            key = {"assemble_force_cloth": "tet_force_nodes", "ell_matvec_cloth": "ell_matvec",
                   "pcg_cloth": "pcg"}.get(name, name)
            r["launches"] = launches["6"][key]
        else:
            r["launches"] = launches["5" if name in generic[1:4] else "3b"][name]
        if name in list(wrappers)[:8]:
            # T1-T8: the soup's path (3b) and the ensemble's (13, B = 64).
            r["launches_by_path"] = {p: launches[p][name] for p in ("3b", "13")}
        if name in generic_ens:
            # The generic path's ensembles: 15b (B = 64 x tet_cube_drop), and
            # 15c's cloth and soup where only they reach the kernel.
            paths = {"15b": launches["15b"][name]}
            if launches["15b"][name] == 0:
                paths.update({p: launches[p][name] for p in ("15c cloth", "15c soup")})
            r.setdefault("launches_by_path", {}).update(paths)
        # The generic path's ensembles with self-contact (16a, 16b and 16c's
        # other branches and terms) and with edge-edge and node-node contacts
        # (17a, 17b, 17c's tet boxes with all three), where they reach the
        # kernel.
        key = {"assemble_force_contacts": "tet_force_nodes", "ell_matvec_band": "ell_matvec",
               "assemble_force_cloth": "tet_force_nodes", "ell_matvec_cloth": "ell_matvec",
               "pcg_cloth": "pcg"}.get(name, name)
        contact_paths = {p: launches[p][key] for p in CONTACT_PATHS + EDGE_PATHS + (
            "19 reference", "19 celllist") + DOMAIN_PATHS if launches[p].get(key)}
        if contact_paths:
            r.setdefault("launches_by_path", {}).update(contact_paths)
        table.append(r)
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
