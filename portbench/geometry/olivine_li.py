"""Olivine LiFePO4 (space group Pnma, No. 62) as a host for Li hopping: the
static atoms are Fe, P and O, the sites are the Li positions (Wyckoff 4a),
and each site's vertices are the 6 O of its LiO6 octahedron.

The structure is the configuration's: the lattice lengths ``cell_A`` and
the asymmetric unit ``asymmetric_unit`` (fractional coordinates of Li 4a,
Fe 4c, P 4c, O1 4c, O2 4c, O3 8d, after Streltsov, Belokoneva, Tsirelson &
Hansen, Acta Cryst. B49, 147 (1993)), expanded by Pnma's 8 general
operations (duplicates merged: 4 Li, 4 Fe, 4 P and 16 O a cell) and
repeated ``n_cells`` times along a, b and c.  A site's vertices are its 6
nearest O under the minimum image; the 6th lies under 2.3 A and the 7th
over 3 A, or the build fails.

The octahedra share edges only along their own [010] chain, so an O is a
vertex of one or two sites and Fe and P of none: few shared vertices, the
gather route (K3).  The Li sites themselves form straight chains along b,
b/2 apart, the path of Li diffusion in olivine.

``grid`` encodes that one-dimensional network for the harness's
``centred_sites``, which makes every site a neighbour of the sites one
block step away along each axis: a site in cell ``(ix, iy, iz)`` at
fractional ``(x, y, z)`` has the index ``(2 (2 ix + [x = 1/2]), 2 iy +
[y = 1/2], 2 iz)``.  With a block step of 1, a step along b reaches the
next site of the chain, and a step along a or c reaches an odd index that
no site holds, so only the two b-neighbours are grid neighbours."""
import numpy as np

# Pnma's general positions (International Tables, origin at -1): each maps
# (x, y, z) to R (x, y, z) + t
_OPS = [
    ((1, 1, 1), (0.0, 0.0, 0.0)),
    ((-1, -1, 1), (0.5, 0.0, 0.5)),
    ((-1, 1, -1), (0.0, 0.5, 0.0)),
    ((1, -1, -1), (0.5, 0.5, 0.5)),
    ((-1, -1, -1), (0.0, 0.0, 0.0)),
    ((1, 1, -1), (0.5, 0.0, 0.5)),
    ((1, -1, 1), (0.0, 0.5, 0.0)),
    ((-1, 1, 1), (0.5, 0.5, 0.5)),
]
STATIC = ("Fe", "P", "O")
VERTEX = "O"
SITE = "Li"
N_VERTICES = 6
_MERGE = 1e-6           # fractional distance under which images coincide


def orbit(xyz):
    """The distinct images ``(n, 3)`` in [0, 1) of the fractional position
    ``xyz`` under Pnma's general operations."""
    out = []
    for r, t in _OPS:
        p = (np.asarray(r, np.float64) * xyz + t) % 1.0
        d = np.asarray(out) - p if out else np.empty((0, 3))
        d -= np.round(d)
        if not out or np.abs(d).max(-1).min() > _MERGE:
            out.append(p)
    return np.asarray(out)


def unit_cell(asym):
    """``{species: (n, 3) fractional positions in one cell}`` from the
    asymmetric unit ``{label: [species, x, y, z]}``."""
    cell = {}
    for species, *xyz in asym.values():
        cell.setdefault(species, []).append(orbit(np.asarray(xyz,
                                                             np.float64)))
    return {s: np.concatenate(v) for s, v in cell.items()}


def _supercell(frac, n):
    """Fractional positions of the supercell ``n = (na, nb, nc)`` ordered
    by cell then by position in the cell, and each one's cell index."""
    idx = np.stack(np.meshgrid(*[np.arange(k) for k in n], indexing="ij"),
                   axis=-1).reshape(-1, 1, 3)
    pos = (idx + frac[None]) / np.asarray(n, np.float64)
    cells = np.broadcast_to(idx, pos.shape)
    return pos.reshape(-1, 3), cells.reshape(-1, 3)


def nearest(points, atoms, cell, k):
    """Indices ``(P, k)`` of each point's ``k + 1`` nearest ``atoms`` under
    the minimum image, and their distances ``(P, k + 1)``, nearest first."""
    inv = np.linalg.inv(cell)
    fa = atoms @ inv
    idx = np.empty((len(points), k + 1), np.int64)
    dist = np.empty((len(points), k + 1))
    for lo in range(0, len(points), 256):
        d = (points[lo:lo + 256] @ inv)[:, None] - fa[None]
        d = (d - np.round(d)) @ cell
        r = np.sqrt((d * d).sum(-1))
        part = np.argpartition(r, k, axis=1)[:, :k + 1]
        order = np.argsort(np.take_along_axis(r, part, 1), axis=1)
        idx[lo:lo + 256] = np.take_along_axis(part, order, 1)
        dist[lo:lo + 256] = np.take_along_axis(r, idx[lo:lo + 256], 1)
    return idx, dist


def build(cfg):
    n = tuple(int(k) for k in cfg["n_cells"])
    lengths = np.asarray(cfg["cell_A"], np.float64)
    cell = np.diag(lengths * n)
    frac = unit_cell(cfg["asymmetric_unit"])
    static, start = [], {}
    for s in STATIC:
        start[s] = sum(len(p) for p in static)
        static.append(_supercell(frac[s], n)[0] @ cell)
    static = np.concatenate(static)
    li, cells = _supercell(frac[SITE], n)
    sites = li @ cell
    half = np.isclose((li * n) % 1.0, 0.5).astype(np.int64)  # in-cell x, y
    grid = np.stack([2 * (2 * cells[:, 0] + half[:, 0]),
                     2 * cells[:, 1] + half[:, 1], 2 * cells[:, 2]], axis=1)
    o_lo = start[VERTEX]
    o = static[o_lo:o_lo + len(frac[VERTEX]) * int(np.prod(n))]
    idx, dist = nearest(sites, o, cell, N_VERTICES)
    if not (dist[:, N_VERTICES - 1].max() < 2.3
            and dist[:, N_VERTICES].min() > 3.0):
        raise ValueError("the Li sites' O octahedra are not separated: 6th "
                         f"O at up to {dist[:, N_VERTICES - 1].max():.3f} A, "
                         f"7th from {dist[:, N_VERTICES].min():.3f} A")
    verts = (o_lo + idx[:, :N_VERTICES]).astype(np.int32)
    return dict(cell=cell, static=static, sites=sites, verts=verts,
                grid=grid, species_start=start)
