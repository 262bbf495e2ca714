"""Small scenes in self-contact built from the reference's own primitives,
the ones that take the per-triangle detection branches (at most 1,024
triangles): a pile of ``create_box``es and a ``create_tet_box`` thrown onto
another.  Works on either package's ``Solver`` (it calls the public
builders only).
"""

from __future__ import annotations


def add_box_pile(s, n_boxes: int = 5, gap: float = 0.3):
    """``n_boxes`` ``create_box``es (5 × 5 × 5 distance lattices of side 4,
    192 surface triangles each: 960 for five, under the all-pairs limit of
    1,024) stacked with gaps of ``gap``, the lowest 0.02 over the floor,
    each staggered by (0.37, 0.23) in x and z so that no node lies on
    another box's lattice.  With the default gap the boxes touch from tick
    ~27, once the lowest rests on the floor."""
    for i in range(n_boxes):
        s.create_box((0.37 * i, 0.02 + (4.0 + gap) * i, 0.23 * i), 1.0, 1000.0)
    return s


def add_tet_boxes(s):
    """Two ``create_tet_box``es (3 × 3 × 3 lattices of side 2, 48 surface
    triangles each), the upper one 0.28 above the lower, staggered off its
    lattice and thrown down at 3 units/s: they touch from tick ~5."""
    s.create_tet_box((0.0, 0.02, 0.0), 1.0, (0.0, 0.0, 0.0), 1500.0, 1.0)
    s.create_tet_box((0.37, 2.3, 0.23), 1.0, (0.0, -3.0, 0.0), 1500.0, 1.0)
    return s
