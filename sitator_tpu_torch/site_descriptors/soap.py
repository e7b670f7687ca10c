"""SOAP-style descriptors (power spectrum of a local density expansion)
as dense batched tensor products (counterpart of
``sitator_tpu.site_descriptors.soap``).

The expansion evaluates an orthonormalised radial basis × real spherical
harmonics at neighbour positions (smooth-cutoff weighted) and forms the
rotation-invariant power spectrum

    p^{αβ}_{n n' l} = Σ_m c^α_{nlm} c^β_{n'lm},

per species pair — the same invariance structure as GAP SOAP.

**Radial basis.**  Two orthonormalized radial bases are provided, selected
by ``radial_basis``:

- ``'gauss'`` (default): Gaussians on an equispaced grid in ``[0, r_cut]``,
  orthonormalized by the inverse square root of their overlap matrix
  ``S_{nn'} = ∫ φ_n φ_{n'} r² dr`` — the same Löwdin treatment dscribe
  applies to its GTO primitives, so coefficients are true projections onto
  an orthonormal set rather than raw samples of overlapping Gaussians;
- ``'poly'``: the dscribe-style polynomial basis ``φ_n(r) ∝ (r_cut − r)^{n+2}``,
  likewise Löwdin-orthonormalized.

**Density model** (``density=``):

- ``'delta'`` (default): the neighbour density is a delta density evaluated
  at atom positions — radial smearing folded into the basis width, angular
  smearing absent.  Fast and adequate for within-backend site typing, but
  absolute values differ from quippy/dscribe.
- ``'gauss'``: GAP-fidelity atom-centred Gaussian smearing.  The exact
  expansion of a Gaussian at distance ``R`` along ``r̂_j`` is

      c_nlm = 4π Y_lm(r̂_j) ∫ u_n(r) r² e^{-(r²+R²)/2σ²} i_l(rR/σ²) dr,

  with ``i_l`` the modified spherical Bessel function.  The radial
  integrals ``I_nl(R)`` are quadratured host-side in float64 ONCE per
  configuration (exp-scaled Bessels, no overflow at any σ) onto a dense
  ``R`` table; the device code linearly interpolates the table per
  neighbour and runs the same dense products as the delta path.

**Precision and memory.**  Every product is full float32: on a CUDA device
with TF32 matrix products enabled (``torch.backends.cuda.matmul.allow_tf32``)
the entry points raise instead of changing the caller's global setting.
The contraction over neighbours is one batched matrix product a probe batch,
``(P, S·n, N) @ (P, N, L2)``, so no ``(P, N, n, L2)`` temporary is formed
(3.7 GB at 256 probes × 9261 atoms with the default ``n_max=8, l_max=6``).

The descriptor interface is pluggable, so an external SOAP can be swapped
in where available.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from sitator_tpu_torch.ops.pbc import min_image_disp

__all__ = ["soap_descriptors", "soap_descriptors_env",
           "radial_orthonormalizer", "radial_smearing_table",
           "SOAPDescriptorAverages", "SiteCentersDescriptor"]


def _real_sph_harm(unit_vecs, l_max):
    """Real spherical harmonics Y_lm at unit vectors (..., 3) for
    l = 0..l_max.  Returns (..., (l_max+1)^2) ordered [(l, m)] with
    m = -l..l (sin components for m<0, cos for m>0)."""
    x, y, z = unit_vecs[..., 0], unit_vecs[..., 1], unit_vecs[..., 2]
    ct = torch.clamp(z, -1.0, 1.0)                     # cos(theta)
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))   # sin(theta)
    phi = torch.atan2(y, x)

    # associated Legendre P_l^m(ct) via stable recurrences
    P = {}
    P[(0, 0)] = torch.ones_like(ct)
    for m in range(1, l_max + 1):
        P[(m, m)] = (2 * m - 1) * st * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    cos_m = {m: torch.cos(m * phi) for m in range(1, l_max + 1)}
    sin_m = {m: torch.sin(m * phi) for m in range(1, l_max + 1)}
    feats = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - am)
                             / math.factorial(l + am))
            if m == 0:
                feats.append(norm * P[(l, 0)])
            elif m > 0:
                feats.append(math.sqrt(2) * norm * P[(l, m)] * cos_m[m])
            else:
                feats.append(math.sqrt(2) * norm * P[(l, am)] * sin_m[am])
    return torch.stack(feats, dim=-1)


def radial_orthonormalizer(r_cut, sigma, n_max, radial_basis="gauss",
                           n_quad=2048, drop_tol=1e-7):
    """Canonical orthogonalization ``W`` of the radial basis:
    ``u = φ @ W`` satisfies ``∫ u_n u_{n'} r² dr = δ_{nn'}`` on the kept
    channels.

    ``S_{nn'} = ∫_0^{r_cut} φ_n φ_{n'} r² dr`` by quadrature (host-side,
    once per configuration).  Primitives are norm-scaled first, then
    eigen-directions of the normalized overlap below ``drop_tol · λ_max``
    are DROPPED (their columns of ``W`` zeroed) — the quantum-chemistry
    canonical-orthogonalization treatment for near-linearly-dependent
    bases, which the dscribe-style polynomial primitives are (their raw
    overlap spans ~15 decades at n_max=8; symmetric Löwdin would either
    blow up in f32 or silently de-orthonormalize under eigenvalue
    clamping).  Dropped channels carry no independent radial information;
    the descriptor layout keeps its static shape.  Projecting a delta
    density onto the orthonormal set is exactly ``c_raw @ W``.
    """
    r = np.linspace(0.0, r_cut, n_quad)
    phi = _radial_raw_np(r, r_cut, sigma, n_max, radial_basis)  # (Q, n)
    S = np.trapezoid(phi[:, :, None] * phi[:, None, :]
                     * (r ** 2)[:, None, None], r, axis=0)
    norms = np.sqrt(np.diag(S))
    Sn = S / norms[:, None] / norms[None, :]
    lam, V = np.linalg.eigh(Sn)
    keep = lam > drop_tol * lam.max()
    W = np.zeros((n_max, n_max))
    W[:, keep] = (V[:, keep] / np.sqrt(lam[keep])) / norms[:, None]
    return W


def _radial_raw_np(r, r_cut, sigma, n_max, radial_basis):
    """Raw (pre-orthonormalization) radial basis, NumPy: (len(r), n_max)."""
    r = np.asarray(r, np.float64)
    if radial_basis == "gauss":
        centers = np.linspace(0.0, r_cut, n_max)
        return np.exp(-((r[:, None] - centers[None, :]) ** 2)
                      / (2.0 * sigma ** 2))
    if radial_basis == "poly":
        # dscribe's polynomial basis: (r_cut - r)^(n+2), zero-valued and
        # zero-sloped at the cutoff for every n
        powers = np.arange(n_max) + 2
        return np.where(r[:, None] < r_cut,
                        (r_cut - np.minimum(r, r_cut))[:, None] ** powers,
                        0.0)
    raise ValueError("radial_basis must be 'gauss' or 'poly'")


def radial_smearing_table(r_cut, sigma, n_max, l_max, radial_basis="gauss",
                          W=None, n_grid=512, n_quad=2048):
    """Analytic radial integrals for the Gaussian-smeared density,
    tabulated on a uniform neighbor-distance grid.

    ``I_nl(R) = 4π ∫_0^{r_cut} u_n(r) r² e^{-(r²+R²)/2σ²} i_l(rR/σ²) dr``
    where ``u = φ @ W`` is the orthonormal radial basis and ``i_l`` the
    modified spherical Bessel function of the first kind.  Computed with
    exp-scaled Bessels (``e^{-x} i_l(x)``) so the integrand is
    ``u_n(r) r² e^{-(r-R)²/2σ²} [e^{-x} i_l(x)]`` — overflow-free at any
    σ.  Returns ``(table, dR)`` with ``table`` of shape
    ``(n_grid, n_max, l_max+1)`` float64 over ``R ∈ [0, r_cut]``.
    """
    from scipy.special import ive

    if W is None:
        W = radial_orthonormalizer(r_cut, sigma, n_max, radial_basis)
    r = np.linspace(0.0, r_cut, n_quad)
    u = _radial_raw_np(r, r_cut, sigma, n_max, radial_basis) @ W  # (Q, n)
    R = np.linspace(0.0, r_cut, n_grid)
    x = np.maximum(r[:, None] * R[None, :] / (sigma ** 2), 0.0)   # (Q, G)
    gauss = np.exp(-((r[:, None] - R[None, :]) ** 2)
                   / (2.0 * sigma ** 2))                          # (Q, G)
    table = np.empty((n_grid, n_max, l_max + 1))
    dblfact = 1.0
    for l in range(l_max + 1):
        if l > 0:
            dblfact *= (2 * l + 1)
        # e^{-x} i_l(x); series limit x^l/(2l+1)!! below quadrature noise
        with np.errstate(invalid="ignore", divide="ignore"):
            il = np.sqrt(np.pi / (2.0 * np.maximum(x, 1e-300))) \
                * ive(l + 0.5, x)
        small = x < 1e-6
        il = np.where(small, (x ** l) / dblfact * np.exp(-x), il)
        kern = 4.0 * np.pi * gauss * il * (r ** 2)[:, None]       # (Q, G)
        # (Q, G) x (Q, n) -> (G, n)
        table[:, :, l] = np.trapezoid(kern[:, :, None] * u[:, None, :],
                                      r, axis=0).reshape(n_grid, n_max)
    return table, R[1] - R[0]


def _radial_raw(r, r_cut, sigma, n_max, radial_basis):
    """Raw radial basis on tensors: ``r (...,)`` → ``(..., n_max)``."""
    if radial_basis == "gauss":
        centers = torch.linspace(0.0, r_cut, n_max, dtype=r.dtype,
                                 device=r.device)
        return torch.exp(-((r[..., None] - centers) ** 2)
                         / (2.0 * sigma ** 2))
    powers = torch.arange(n_max, device=r.device) + 2
    base = torch.clamp_min(r_cut - r, 0.0)
    return base[..., None] ** powers


def _require_full_f32(device):
    """Refuse TF32: the three contractions below must be full float32."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "soap_descriptors needs full float32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def _soap_batch(probes, positions, species_onehot, cell, cell_inv, r_cut,
                sigma, n_max, l_max, W, radial_basis="gauss",
                smear_table=None):
    """SOAP vectors for a batch of probes: ``probes (P, 3)``; ``positions``
    ``(N, 3)`` shared or ``(P, N, 3)`` one environment a probe;
    ``species_onehot (N, S)`` with zero rows for atoms to ignore; ``W`` the
    radial orthonormalizer from :func:`radial_orthonormalizer`.
    ``smear_table``: the :func:`radial_smearing_table` array
    ``(G, n_max, l_max+1)`` in float32 — switches the density model from
    delta to Gaussian-smeared (the table's R grid spans ``[0, r_cut]``).
    Returns ``(P, D)`` unit-norm rows."""
    n_probes = probes.shape[0]
    n_species = species_onehot.shape[1]
    disp = min_image_disp(positions - probes[:, None, :], cell, cell_inv)
    r = torch.sqrt((disp * disp).sum(-1))                      # (P, N)
    unit = disp / torch.clamp_min(r, 1e-9)[..., None]

    # smooth cosine cutoff; excludes atoms beyond r_cut
    fcut = torch.where(r < r_cut,
                       0.5 * (torch.cos(math.pi * r / r_cut) + 1.0), 0.0)
    Y = _real_sph_harm(unit, l_max)                            # (P, N, L2)
    w = species_onehot * fcut[..., None]                       # (P, N, S)
    l_sizes = [2 * l + 1 for l in range(l_max + 1)]

    if smear_table is not None:
        # per-neighbour radial integrals by linear interpolation of the
        # host-precomputed table: (P, N) -> (P, N, n_max, l_max+1)
        G = smear_table.shape[0]
        t = torch.clamp(r / r_cut * (G - 1), 0.0, G - 1)
        i0 = torch.clamp(t.to(torch.int32), 0, G - 2).long()
        f = (t - i0)[..., None, None]
        gl = smear_table[i0] * (1.0 - f) + smear_table[i0 + 1] * f
        # c[s, n, lm] = sum_j w[j, s] gl[j, n, l(lm)] Y[j, lm]: one batched
        # product an l, over that l's block of Y, so the table is never
        # expanded to (P, N, n, L2)
        blocks, lo = [], 0
        for l, sz in enumerate(l_sizes):
            a = (w[..., :, None] * gl[..., None, :, l]).reshape(
                n_probes, -1, n_species * n_max)               # (P, N, S·n)
            blocks.append(a.transpose(1, 2) @ Y[..., lo:lo + sz])
            lo += sz
        c = torch.cat(blocks, dim=-1)                          # (P, S·n, L2)
    else:
        g = _radial_raw(r, r_cut, sigma, n_max, radial_basis)  # (P, N, n)
        g = g @ W                 # project onto the ORTHONORMAL basis
        # c[s, n, lm] = sum_j onehot[j, s] fcut[j] g[j, n] Y[j, lm]
        a = (w[..., :, None] * g[..., None, :]).reshape(
            n_probes, -1, n_species * n_max)                   # (P, N, S·n)
        c = a.transpose(1, 2) @ Y                              # (P, S·n, L2)
    c = c.reshape(n_probes, n_species, n_max, -1)

    # power spectrum per (s, s', n, n', l): sum over m
    out, lo = [], 0
    for sz in l_sizes:
        cl = c[..., lo:lo + sz]                                # (P, S, n, m)
        pl = torch.einsum("bsnm,btpm->bstnp", cl, cl) / math.sqrt(sz)
        out.append(pl.reshape(n_probes, -1))
        lo += sz
    p = torch.cat(out, dim=1)
    norm = torch.sqrt((p * p).sum(dim=1, keepdim=True))
    return p / torch.clamp_min(norm, 1e-12)


def _species_onehot(species, species_list):
    onehot = np.zeros((len(species), len(species_list)), dtype=np.float32)
    for i, s in enumerate(species_list):
        onehot[np.asarray(species) == s, i] = 1.0
    return onehot


def _run_batches(probes, envs, species, cell, r_cut, sigma, n_max, l_max,
                 species_list, batch, radial_basis, W, density, smear_table,
                 device):
    """The loop behind both entry points: ``envs`` is ``(N, 3)`` (one
    environment for all probes, uploaded once) or ``(P, N, 3)`` (uploaded a
    batch at a time)."""
    device = torch.device(device)
    _require_full_f32(device)
    if density not in ("delta", "gauss"):
        raise ValueError("density must be 'delta' or 'gauss'")
    if species_list is None:
        species_list = np.unique(species)

    def on(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=device)

    cell = np.asarray(cell, dtype=np.float32)
    cell_inv = np.linalg.inv(cell).astype(np.float32)
    if W is None:
        W = radial_orthonormalizer(r_cut, sigma, n_max, radial_basis)
    smear = None
    if density == "gauss":
        if smear_table is None:
            smear_table = radial_smearing_table(
                r_cut, sigma, n_max, l_max, radial_basis, W=W)[0]
        smear = on(smear_table)
    onehot = on(_species_onehot(species, species_list))
    cell_t, cell_inv_t, W_t = on(cell), on(cell_inv), on(W)
    probes = np.asarray(probes, dtype=np.float32)
    shared = envs.ndim == 2
    if shared:
        env_t = on(envs)
    outs = []
    for lo in range(0, len(probes), batch):
        if not shared:
            env_t = on(envs[lo:lo + batch])
        outs.append(_soap_batch(
            on(probes[lo:lo + batch]), env_t, onehot, cell_t, cell_inv_t,
            r_cut, sigma, n_max, l_max, W_t, radial_basis=radial_basis,
            smear_table=smear).cpu().numpy())
    return np.concatenate(outs, axis=0)


def soap_descriptors(probes, positions, species, cell, r_cut=5.0,
                     sigma=0.5, n_max=8, l_max=6, species_list=None,
                     batch=256, radial_basis="gauss", density="delta",
                     device="cuda"):
    """SOAP vectors for ``probes (P, 3)`` in the environment of
    ``positions (N, 3)`` with ``species (N,)``.  Returns (P, D) float32.
    ``density``: 'delta' or 'gauss' (GAP-fidelity atom-centred Gaussian
    smearing of width ``sigma`` — see module docstring).  ``batch`` probes
    a dispatch on ``device``.
    """
    return _run_batches(
        probes, np.asarray(positions, dtype=np.float32), np.asarray(species),
        cell, r_cut, sigma, n_max, l_max, species_list, batch, radial_basis,
        None, density, None, device)


def soap_descriptors_env(probes, envs, species, cell, r_cut=5.0,
                         sigma=0.5, n_max=8, l_max=6, species_list=None,
                         batch=64, radial_basis="gauss", W=None,
                         density="delta", smear_table=None, device="cuda"):
    """SOAP vectors for ``probes (P, 3)``, each in its OWN environment
    ``envs (P, N, 3)`` (e.g. per-frame static lattices) with shared
    ``species (N,)``.  One device dispatch per ``batch`` probes — the
    sampling path of :class:`SOAPDescriptorAverages`.  ``W`` /
    ``smear_table``: optional precomputed :func:`radial_orthonormalizer` /
    :func:`radial_smearing_table` (hoist them when calling in a loop)."""
    return _run_batches(
        probes, np.asarray(envs, dtype=np.float32), species, cell, r_cut,
        sigma, n_max, l_max, species_list, batch, radial_basis, W, density,
        smear_table, device)


class SOAPDescriptorAverages:
    """Per-site SOAP by averaging descriptors of sampled assigned positions
    (reference ``SOAPDescriptorAverages`` parity): probes are real mobile-ion
    positions while assigned to the site, each evaluated in its own frame's
    static-lattice environment, then averaged per site.

    ``get_descriptors(st)`` → ((n_sites, D), counts).
    """

    def __init__(self, r_cut=5.0, sigma=0.5, n_max=8, l_max=6,
                 averages_n=16, seed=0, radial_basis="gauss",
                 density="delta", verbose=True, device="cuda"):
        self.r_cut = float(r_cut)
        self.sigma = float(sigma)
        self.n_max = int(n_max)
        self.l_max = int(l_max)
        self.averages_n = int(averages_n)
        self.seed = seed
        self.radial_basis = radial_basis
        self.density = density
        self.verbose = verbose
        self.device = device

    def get_descriptors(self, st):
        sn = st.site_network
        if st.real_trajectory is None:
            raise ValueError("SiteTrajectory needs a real trajectory")
        rng = np.random.default_rng(self.seed)
        static_idx = np.flatnonzero(sn.static_mask)
        mobile_idx = np.flatnonzero(sn.mobile_mask)
        species = sn.structure.species[static_idx]
        species_list = np.unique(species)
        cell = sn.structure.cell

        # one pass over the assignment matrix: group samples by site, then
        # draw up to averages_n per site
        fr_all, io_all = np.nonzero(st.traj >= 0)
        lab_all = st.traj[fr_all, io_all]
        sel_f, sel_i, sel_s = [], [], []
        counts = np.zeros(sn.n_sites, dtype=np.int64)
        order = np.argsort(lab_all, kind="stable")
        bounds = np.searchsorted(lab_all[order], np.arange(sn.n_sites + 1))
        for site in range(sn.n_sites):
            grp = order[bounds[site]:bounds[site + 1]]
            if len(grp) == 0:
                continue
            if len(grp) > self.averages_n:
                grp = grp[rng.choice(len(grp), self.averages_n,
                                     replace=False)]
            # convention (as in the reference): counts = number of
            # samples actually averaged, capped at averages_n
            counts[site] = len(grp)
            sel_f.append(fr_all[grp])
            sel_i.append(io_all[grp])
            sel_s.append(np.full(len(grp), site, dtype=np.int64))
        if not sel_f:
            raise ValueError("SiteTrajectory has no assigned samples")
        sel_f = np.concatenate(sel_f)
        sel_i = np.concatenate(sel_i)
        sel_s = np.concatenate(sel_s)

        # every probe is a real ion position evaluated in ITS OWN frame's
        # static environment — batched into device dispatches;
        # environments are gathered chunkwise (T·N·3 all at once can be GBs)
        probes = st.real_trajectory[sel_f, mobile_idx[sel_i]]
        chunk = 512
        d_parts = []
        W = radial_orthonormalizer(self.r_cut, self.sigma, self.n_max,
                                   self.radial_basis)
        smear = (radial_smearing_table(self.r_cut, self.sigma, self.n_max,
                                       self.l_max, self.radial_basis,
                                       W=W)[0]
                 if self.density == "gauss" else None)
        for lo in range(0, len(sel_f), chunk):
            f_c = sel_f[lo:lo + chunk]
            envs = st.real_trajectory[f_c][:, static_idx]
            d_parts.append(soap_descriptors_env(
                probes[lo:lo + chunk], envs, species, cell,
                r_cut=self.r_cut, sigma=self.sigma, n_max=self.n_max,
                l_max=self.l_max, species_list=species_list,
                radial_basis=self.radial_basis, W=W,
                density=self.density, smear_table=smear,
                device=self.device))
        d_all = np.concatenate(d_parts, axis=0)

        D = d_all.shape[1]
        out = np.zeros((sn.n_sites, D), dtype=np.float64)
        np.add.at(out, sel_s, d_all.astype(np.float64))
        n_sel = np.bincount(sel_s, minlength=sn.n_sites)
        occupied = n_sel > 0
        out[occupied] /= n_sel[occupied, None]
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        out = np.where(norms > 1e-12, out / np.maximum(norms, 1e-12), out)
        return out.astype(np.float32), counts


class SiteCentersDescriptor:
    """Per-center SOAP variant (reference's per-center descriptor ⚠):
    probes at the site centers, environment = the static reference
    structure."""

    def __init__(self, r_cut=5.0, sigma=0.5, n_max=8, l_max=6,
                 radial_basis="gauss", density="delta", device="cuda"):
        self.r_cut = float(r_cut)
        self.sigma = float(sigma)
        self.n_max = int(n_max)
        self.l_max = int(l_max)
        self.radial_basis = radial_basis
        self.density = density
        self.device = device

    def get_descriptors(self, st_or_sn):
        sn = getattr(st_or_sn, "site_network", st_or_sn)
        static = sn.static_structure
        d = soap_descriptors(sn.centers, static.positions, static.species,
                             sn.structure.cell, r_cut=self.r_cut,
                             sigma=self.sigma, n_max=self.n_max,
                             l_max=self.l_max,
                             radial_basis=self.radial_basis,
                             density=self.density, device=self.device)
        return d, np.full(sn.n_sites, 1)
