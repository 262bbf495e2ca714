"""A cloth sheet dropped onto a tet soup: the mixed scene that drives the
super-body detection (a packed prefix of tets and one loose row per cloth
triangle), the contact terms of the generic PD path and the banded tet
operator.

Built on a solver's scene lists (``solver._builder``) as
``scripts/bench_all.py:182-205`` builds its
``mixed_cloth_over_soup`` row: ``create_tet_soup(n_tets, spacing=1.6,
scale=0.8, w=2000, height=0.5, jitter=0.05)``, then an unpinned ``sheet_n ×
sheet_n`` lattice at ``y = 3.2`` over ``±0.4·side`` (``side`` the soup's
lattice side), ``inv_mass`` 1, radius 0.25, three distance families at weight
4000 and two triangles per cell.  The soup is emitted first, so its tets
index the nodes as ``arange`` (a banded layout) and its four faces per tet
are the packed prefix of the collision rows.

At ``n_tets = 125_000`` and ``sheet_n = 100`` (the sheet's pitch about that
of the 12,500-tet scene with its 48 × 48 sheet): 510,000 nodes, 519,602
triangles, 29,601 distance pairs, 144,602 collision rows.  Works on either
package's ``Solver`` (it uses ``create_tet_soup`` and those lists only).
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def sheet_side(n_tets: int, spacing: float = 1.6) -> int:
    """The soup's lattice side, as ``bench_all`` computes it."""
    return int(np.ceil((n_tets * spacing ** 3) ** (1 / 3)))


def add_mixed_drape(solver, n_tets: int = 125_000, sheet_n: int = 100, *,
                    spacing: float = 1.6, scale: float = 0.8, w_soup: float = 2000.0,
                    height: float = 0.5, jitter: float = 0.05, sheet_y: float = 3.2,
                    w_sheet: float = 4000.0, radius: float = 0.25) -> np.ndarray:
    """Add the soup and the sheet to ``solver``; returns the sheet nodes'
    global ids (``ids.reshape(sheet_n, sheet_n)[i, j]`` is lattice node
    (i, j))."""
    solver.create_tet_soup(n_tets, spacing=spacing, scale=scale, w=w_soup, height=height,
                           jitter=jitter)
    side = sheet_side(n_tets, spacing)
    b = solver._builder
    sx = np.linspace(-side * 0.4, side * 0.4, sheet_n, dtype=_F32)
    gx, gz = np.meshgrid(sx, sx, indexing="ij")
    pts = np.stack([gx, np.full_like(gx, sheet_y), gz], -1).reshape(-1, 3)
    ids = b._emit_nodes(pts, inv_mass=1.0, radius=radius)
    g = ids.reshape(sheet_n, sheet_n)
    pairs = np.concatenate([
        np.stack([g[:-1, :].ravel(), g[1:, :].ravel()], 1),
        np.stack([g[:, :-1].ravel(), g[:, 1:].ravel()], 1),
        np.stack([g[:-1, :-1].ravel(), g[1:, 1:].ravel()], 1),
    ])
    b._emit_distance(pairs, w_sheet)
    tris = np.concatenate([
        np.stack([g[:-1, :-1].ravel(), g[1:, :-1].ravel(), g[1:, 1:].ravel()], 1),
        np.stack([g[:-1, :-1].ravel(), g[1:, 1:].ravel(), g[:-1, 1:].ravel()], 1),
    ])
    b._emit_triangles(tris)
    solver._dirty = True
    return ids
