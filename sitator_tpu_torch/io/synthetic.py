"""Synthetic-MD trajectory generator with known ground truth.

The reference has no test suite; its de-facto integration test is an example
notebook on a real AIMD trajectory (SURVEY.md §5).  This generator replaces
that: a host lattice with frozen disorder + thermal jitter, and mobile ions
hopping among known interstitial sites via a Poisson process — so site-count
recovery and jump-rate parity (BASELINE.md parity gates) can be asserted
exactly against ground truth.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from sitator_tpu_torch.core.structure import Structure


@dataclass
class SyntheticMD:
    """A generated trajectory plus its ground truth."""

    structure: Structure            # reference (frame-0 ideal) structure
    static_mask: np.ndarray         # (n_atoms,)
    mobile_mask: np.ndarray         # (n_atoms,)
    traj: np.ndarray                # (n_frames, n_atoms, 3) cartesian
    true_sites: np.ndarray          # (S, 3) ground-truth site centers
    true_assignments: np.ndarray    # (n_frames, n_ions) site index per frame
    true_n_ij: np.ndarray           # (S, S) ground-truth hop counts
    site_neighbors: np.ndarray = field(default=None)  # (S, k) adjacency, -1 pad
    true_site_types: np.ndarray = field(default=None)  # (S,) e.g. oct/tet

    @property
    def n_frames(self):
        return self.traj.shape[0]

    @property
    def n_ions(self):
        return self.true_assignments.shape[1]


def make_hopping_trajectory(
    n_cells: int = 3,
    a: float = 4.0,
    n_ions: int = 4,
    n_frames: int = 2000,
    jump_rate: float = 0.01,
    sigma_mobile: float = 0.25,
    sigma_static: float = 0.04,
    frozen_disorder: float = 0.10,
    host_species: int = 16,
    mobile_species: int = 3,
    seed: int = 0,
    dtype=np.float32,
) -> SyntheticMD:
    """Simple-cubic host lattice; ions hop between body-center sites.

    - Host atoms sit on an ``n_cells^3`` simple-cubic lattice (spacing ``a``)
      with small frozen displacements (breaks the Voronoi degeneracy of the
      ideal lattice, like real materials) plus per-frame thermal jitter
      ``sigma_static``.
    - Sites are the body centers; each frame every ion stays in a harmonic
      well around its site (``sigma_mobile``) and jumps to one of the 6
      neighboring sites with probability ``jump_rate`` per frame (rejected if
      the target is occupied — single occupancy ground truth).
    """
    rng = np.random.default_rng(seed)
    cell = np.eye(3) * (a * n_cells)

    # host lattice + frozen disorder
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float64)
    host = grid * a
    host += rng.normal(scale=frozen_disorder, size=host.shape)
    n_host = len(host)

    # body-center sites on the same periodic grid
    sites = (grid + 0.5) * a
    n_sites = len(sites)
    if n_ions >= n_sites:
        raise ValueError("need n_ions < number of sites for single occupancy")

    # 6-neighbor adjacency on the periodic grid
    idx3 = {tuple(g): i for i, g in enumerate(grid.astype(int))}
    neighbors = np.zeros((n_sites, 6), dtype=np.int64)
    for i, g in enumerate(grid.astype(int)):
        k = 0
        for d in range(3):
            for s in (-1, 1):
                gg = list(g)
                gg[d] = (gg[d] + s) % n_cells
                neighbors[i, k] = idx3[tuple(gg)]
                k += 1

    return _hopping_md(rng, cell, host, sites, neighbors, n_ions, n_frames,
                       jump_rate, sigma_mobile, sigma_static, host_species,
                       mobile_species, dtype)


def _hopping_md(rng, cell, host, sites, neighbors, n_ions, n_frames,
                jump_rate, sigma_mobile, sigma_static, host_species,
                mobile_species, dtype, site_types=None):
    """Shared hopping dynamics + trajectory assembly: Poisson jumps on the
    (possibly ragged, −1-padded) ``neighbors`` adjacency with single
    occupancy, harmonic wells, per-frame thermal jitter."""
    n_host = len(host)
    n_sites = len(sites)
    occ_site = rng.choice(n_sites, size=n_ions, replace=False)
    occupied = np.zeros(n_sites, dtype=bool)
    occupied[occ_site] = True
    assignments = np.zeros((n_frames, n_ions), dtype=np.int32)
    n_ij = np.zeros((n_sites, n_sites), dtype=np.int64)
    # per-site valid-neighbor counts: attempts sample among REAL neighbors
    # only, so the per-site attempt rate is jump_rate regardless of how
    # ragged the adjacency is (tets have 4 slots, octs 8 — padding must
    # not halve the tetrahedral escape rate)
    n_valid = (neighbors >= 0).sum(axis=1)
    for f in range(n_frames):
        for ion in range(n_ions):
            if rng.random() < jump_rate:
                k = n_valid[occ_site[ion]]
                if k == 0:
                    continue  # isolated site: the ion cannot hop
                target = neighbors[occ_site[ion], rng.integers(k)]
                if target >= 0 and not occupied[target]:
                    occupied[occ_site[ion]] = False
                    if f > 0:
                        n_ij[occ_site[ion], target] += 1
                    occ_site[ion] = target
                    occupied[target] = True
        assignments[f] = occ_site

    # assemble cartesian trajectory
    n_atoms = n_host + n_ions
    traj = np.empty((n_frames, n_atoms, 3), dtype=dtype)
    traj[:, :n_host] = host[None] + rng.normal(
        scale=sigma_static, size=(n_frames, n_host, 3))
    ion_centers = sites[assignments]  # (F, n_ions, 3)
    traj[:, n_host:] = ion_centers + rng.normal(
        scale=sigma_mobile, size=(n_frames, n_ions, 3))

    positions = np.concatenate([host, sites[assignments[0]]], axis=0)
    species = np.concatenate([
        np.full(n_host, host_species, dtype=np.int32),
        np.full(n_ions, mobile_species, dtype=np.int32),
    ])
    structure = Structure(positions, species, cell)
    static_mask = np.concatenate(
        [np.ones(n_host, bool), np.zeros(n_ions, bool)])
    mobile_mask = ~static_mask

    return SyntheticMD(
        structure=structure,
        static_mask=static_mask,
        mobile_mask=mobile_mask,
        traj=traj,
        true_sites=sites,
        true_assignments=assignments,
        true_n_ij=n_ij,
        site_neighbors=neighbors,
        true_site_types=site_types,
    )


def make_fcc_hopping_trajectory(
    n_cells: int = 2,
    a: float = 5.0,
    n_ions: int = 4,
    n_frames: int = 2000,
    jump_rate: float = 0.01,
    sigma_mobile: float = 0.18,
    sigma_static: float = 0.04,
    frozen_disorder: float = 0.08,
    host_species: int = 16,
    mobile_species: int = 3,
    seed: int = 0,
    dtype=np.float32,
) -> SyntheticMD:
    """FCC host lattice; ions hop on the tetrahedral/octahedral
    interstitial network — the close-packed geometry of real solid
    electrolytes (the reference paper's headline systems), and the
    textbook case of RAGGED landmark polyhedra: tetrahedral holes have 4
    vertex atoms, octahedral holes 6.

    Sites per conventional cube: 4 octahedral (type 0) + 8 tetrahedral
    (type 1); jumps follow the physical tet↔oct face-sharing network
    (nearest-neighbor pairs at ``a·√3/4``).  ``true_site_types`` carries
    the oct/tet ground truth for typing tests.
    """
    rng = np.random.default_rng(seed)
    L = a * n_cells
    cell = np.eye(3) * L

    cube = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float64)
    fcc_basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                          [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    host = ((cube[:, None, :] + fcc_basis[None, :, :]).reshape(-1, 3)) * a
    host += rng.normal(scale=frozen_disorder, size=host.shape)

    oct_basis = np.array([[0.5, 0.0, 0.0], [0.0, 0.5, 0.0],
                          [0.0, 0.0, 0.5], [0.5, 0.5, 0.5]])
    tet_basis = np.array([[x, y, z] for x in (0.25, 0.75)
                          for y in (0.25, 0.75) for z in (0.25, 0.75)])
    octs = ((cube[:, None, :] + oct_basis[None, :, :]).reshape(-1, 3)) * a
    tets = ((cube[:, None, :] + tet_basis[None, :, :]).reshape(-1, 3)) * a
    sites = np.concatenate([octs, tets])
    site_types = np.concatenate([np.zeros(len(octs), np.int32),
                                 np.ones(len(tets), np.int32)])
    n_sites = len(sites)
    if n_ions >= n_sites:
        raise ValueError("need n_ions < number of sites for single occupancy")

    # tet↔oct face-sharing adjacency: min-image pairs at a*sqrt(3)/4
    d = sites[:, None, :] - sites[None, :, :]
    d -= np.round(d / L) * L
    dist = np.linalg.norm(d, axis=-1)
    r_nn = a * np.sqrt(3.0) / 4.0
    adj = (dist < 1.1 * r_nn) & (dist > 1e-9)
    max_nb = int(adj.sum(axis=1).max())
    neighbors = np.full((n_sites, max_nb), -1, dtype=np.int64)
    for i in range(n_sites):
        nb = np.flatnonzero(adj[i])
        neighbors[i, :len(nb)] = nb

    return _hopping_md(rng, cell, host, sites, neighbors, n_ions, n_frames,
                       jump_rate, sigma_mobile, sigma_static, host_species,
                       mobile_species, dtype, site_types=site_types)


def make_langevin_trajectory(
    n_cells: int = 3,
    a: float = 4.0,
    n_ions: int = 4,
    n_frames: int = 1500,
    steps_per_frame: int = 10,
    dt: float = 0.06,
    kT: float = 0.40,
    gamma: float = 1.0,
    k_host: float = 30.0,
    eps: float = 1.0,
    sigma_ih: float = 2.6,
    sigma_ii: float = 3.2,
    m_host: float = 4.0,
    m_ion: float = 1.0,
    host_species: int = 16,
    mobile_species: int = 3,
    seed: int = 0,
    dtype=np.float32,
) -> SyntheticMD:
    """REAL molecular dynamics (not a Poisson process): BAOAB Langevin
    integration of an Einstein-crystal host plus repulsive ions.

    The closest stand-in available for the reference ecosystem's de-facto
    integration test — a real AIMD trajectory (SURVEY.md §5), which the
    package does not ship: here the ion dynamics emerge from equations of
    motion, so the trajectory carries everything Poisson hopping cannot —
    anharmonic in-well motion, barrier recrossings/flicker at the cage
    windows, correlated host—ion vibrations, velocity autocorrelation.

    Model: host atoms tethered harmonically (``k_host``) to an
    ``n_cells³`` simple-cubic lattice (thermal amplitude
    ``sqrt(kT/k_host)``); ions repel hosts and each other via
    ``eps·(σ/r)¹²``.  On the SC lattice the body centers are the true
    potential minima and the face windows the saddles (defaults give a
    barrier of ≈3 kT: hops every ~100 frames/ion).  Integrator: BAOAB
    splitting (Leimkuhler–Matthews) with minimum-image forces; positions
    are left UNWRAPPED (like most MD engines' output), which also
    exercises the analysis stack's imaging.

    Ground truth is *geometric* (unlike the Poisson generators there is
    no imposed site sequence): ``true_assignments`` is the minimum-image
    nearest-cage-center label per frame, and ``true_n_ij`` counts label
    changes that persist ≥ 3 frames (a debounce, so window recrossing
    flicker is not counted as hopping).
    """
    rng = np.random.default_rng(seed)
    L = n_cells * a
    cell = np.eye(3) * L
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float64)
    lat = grid * a
    sites = (grid + 0.5) * a
    n_host = len(lat)
    n_sites = len(sites)
    if n_ions >= n_sites:
        raise ValueError("need n_ions < number of sites")

    occ0 = rng.choice(n_sites, size=n_ions, replace=False)
    xh = lat.copy()
    xi = sites[occ0] + rng.normal(scale=0.1, size=(n_ions, 3))
    vh = rng.normal(scale=np.sqrt(kT / m_host), size=xh.shape)
    vi = rng.normal(scale=np.sqrt(kT / m_ion), size=xi.shape)

    def mi(d):
        return d - L * np.round(d / L)

    eye_big = np.eye(n_ions) * 1e9

    def forces(xh, xi):
        fh = -k_host * (xh - lat)               # tethers (host never hops)
        d = mi(xi[:, None] - xh[None])          # (I, H, 3) min-image
        r2 = (d * d).sum(-1)
        c = 12.0 * eps * sigma_ih**12 / r2**7   # F = c·d (repulsive)
        fi = (c[..., None] * d).sum(1)
        fh = fh - (c[..., None] * d).sum(0)
        dii = mi(xi[:, None] - xi[None])
        r2i = (dii * dii).sum(-1) + eye_big
        ci = 12.0 * eps * sigma_ii**12 / r2i**7
        fi = fi + (ci[..., None] * dii).sum(1)
        return fh, fi

    c1 = np.exp(-gamma * dt)
    c2h = np.sqrt((1.0 - c1 * c1) * kT / m_host)
    c2i = np.sqrt((1.0 - c1 * c1) * kT / m_ion)
    fh, fi = forces(xh, xi)
    traj = np.empty((n_frames, n_host + n_ions, 3), dtype)
    for f in range(n_frames):
        for _ in range(steps_per_frame):
            vh += 0.5 * dt * fh / m_host
            vi += 0.5 * dt * fi / m_ion
            xh += 0.5 * dt * vh
            xi += 0.5 * dt * vi
            vh = c1 * vh + c2h * rng.standard_normal(vh.shape)
            vi = c1 * vi + c2i * rng.standard_normal(vi.shape)
            xh += 0.5 * dt * vh
            xi += 0.5 * dt * vi
            fh, fi = forces(xh, xi)
            vh += 0.5 * dt * fh / m_host
            vi += 0.5 * dt * fi / m_ion
        traj[f, :n_host] = xh
        traj[f, n_host:] = xi

    # geometric ground truth: nearest cage center (min-image) per frame
    d = mi(traj[:, n_host:, None, :].astype(np.float64) - sites[None, None])
    labels = np.argmin((d * d).sum(-1), axis=2).astype(np.int32)
    # debounced hop counts: a change must persist >= 3 frames
    n_ij = np.zeros((n_sites, n_sites), np.int64)
    for i in range(n_ions):
        seq = labels[:, i]
        cur = seq[0]
        k = 1
        while k < len(seq):
            if seq[k] != cur and k + 2 < len(seq) \
                    and seq[k + 1] == seq[k] and seq[k + 2] == seq[k]:
                n_ij[cur, seq[k]] += 1
                cur = seq[k]
            k += 1

    positions = np.concatenate([lat, sites[occ0]], axis=0)
    species = np.concatenate([
        np.full(n_host, host_species, dtype=np.int32),
        np.full(n_ions, mobile_species, dtype=np.int32)])
    structure = Structure(positions, species, cell)
    static_mask = np.concatenate(
        [np.ones(n_host, bool), np.zeros(n_ions, bool)])
    return SyntheticMD(
        structure=structure,
        static_mask=static_mask,
        mobile_mask=~static_mask,
        traj=traj,
        true_sites=sites,
        true_assignments=labels,
        true_n_ij=n_ij,
        site_neighbors=None,
        true_site_types=None,
    )
