"""A cell's inputs from its seed: geometry, centres, the ions' paths, the
pool of distinct frames, and the port's ``SiteNetwork`` over them.

The centred sites are the block of the site grid that the configuration's
``centred_block`` gives (Python ``range`` arguments of each axis's grid
index); two of them are neighbours where their grid indices differ by one
step of the block along one axis.  The hops are those of
``sitator_tpu_torch/io/synthetic.py::make_hopping_trajectory``: the ions
start on ``n_ions`` centred sites drawn from the seed and, each frame,
each settled ion tries with probability ``hop_probability`` to hop to one
of its neighbours drawn at random, which it does when no ion holds or is
bound for it (a NumPy generator seeded with the seed).  A hop crosses the
straight path between the two sites at ``transit_step_A`` a frame: the
ion sits at the path's interior points, one a frame, then on the new site,
holding both sites meanwhile.  The pool's second half is its first half
run backwards, so the pool cycles with no jump at its wrap.  The thermal
jitter (Gaussian, ``lattice_jitter_A`` on every static atom,
``ion_jitter_A`` on every ion) is drawn on the device from a
``torch.Generator`` seeded with the seed, in chunks of frames, and the
pool is kept as one float32 NumPy array ``(P, n_static + n_ions, 3)`` in
host memory, static atoms first."""
import numpy as np
import torch

from portbench.harness import spec

_GEN_FRAMES = 256       # frames drawn on the device in one call


def centred_sites(geo, block):
    """``(centred (K,), neighbours (K, 6))``: the site indices of the
    block, and each one's neighbours as indices into ``centred`` (−1
    where the block ends)."""
    axes = [np.arange(*r) for r in block]
    grid = np.asarray(geo["grid"])
    inside = np.all([np.isin(grid[:, d], axes[d]) for d in range(3)], axis=0)
    centred = np.flatnonzero(inside)
    slot = {tuple(g): k for k, g in enumerate(grid[centred])}
    nbr = np.full((len(centred), 6), -1, np.int64)
    for k, g in enumerate(grid[centred]):
        for d in range(3):
            for j, sign in enumerate((-1, 1)):
                h = g.copy()
                h[d] += sign * int(block[d][2] if len(block[d]) > 2 else 1)
                nbr[k, 2 * d + j] = slot.get(tuple(h), -1)
    return centred, nbr


def hop_paths(rng, sites, nbr, n_ions, n_frames, hop, step):
    """``(start (n_ions,), path (n_frames, n_ions, 3))``: each ion's first
    site (an index into ``sites``) and its position on its path in each
    frame, before the jitter."""
    K = len(sites)
    half = (n_frames + 1) // 2
    occ = rng.choice(K, n_ions, replace=False)
    start = occ.copy()
    held = np.zeros(K, bool)
    held[occ] = True
    n_valid = (nbr >= 0).sum(1)
    dest = np.full(n_ions, -1)          # the site an ion is bound for
    left = np.zeros(n_ions, np.int64)   # transit frames still to go
    total = np.zeros(n_ions, np.int64)
    path = np.empty((half, n_ions, 3))
    for f in range(half):
        moving = dest >= 0
        done = moving & (left <= 0)
        held[occ[done]] = False
        occ[done] = dest[done]
        dest[done] = -1
        settled = (dest < 0) & ~done     # an ion rests a frame on a site
        tries = rng.random(n_ions) < hop
        tries[:] &= f > 0              # every ion starts on its site
        for i in np.flatnonzero(settled & tries):
            s = occ[i]
            if not n_valid[s]:
                continue
            t = nbr[s][nbr[s] >= 0][rng.integers(n_valid[s])]
            if held[t]:
                continue
            held[t] = True
            dest[i] = t
            dist = np.linalg.norm(sites[t] - sites[s])
            total[i] = left[i] = max(int(round(dist / step)) - 1, 0)
        pos = sites[occ].copy()
        moving = dest >= 0
        if moving.any():
            u = (total[moving] - left[moving] + 1) / (total[moving] + 1)
            pos[moving] += u[:, None] * (sites[dest[moving]]
                                         - sites[occ[moving]])
            left[moving] -= 1
        path[f] = pos
    full = np.concatenate([path, path[::-1][:n_frames - half]])
    return start, full


def make(cfg, traffic, seed, device):
    """Everything a run feeds both sides: a dict with ``geo``,
    ``centred``, ``start``, ``path``, ``pool``, ``centres``,
    ``n_static``."""
    geo = spec.module("geometry", cfg["geometry"]).build(cfg)
    n_static = len(geo["static"])
    M, K, P = int(cfg["n_ions"]), int(cfg["n_centres"]), \
        int(cfg["distinct_frames"])
    centred, nbr = centred_sites(geo, cfg["centred_block"])
    if len(centred) != K:
        raise ValueError(f"centred_block holds {len(centred)} sites, not "
                         f"n_centres {K}")
    rng = np.random.default_rng(seed)
    sites = np.asarray(geo["sites"], np.float64)[centred]
    start, path = hop_paths(rng, sites, nbr, M, P,
                                   float(traffic["hop_probability"]),
                                   float(traffic["transit_step_A"]))
    ref = spec.module("reference", cfg["reference"])
    centres = ref.site_centres(sites, geo["static"], geo, cfg)

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    static_ref = torch.as_tensor(geo["static"], dtype=torch.float32,
                                 device=dev)
    s_lat, s_ion = float(traffic["lattice_jitter_A"]), \
        float(traffic["ion_jitter_A"])
    pool = np.empty((P, n_static + M, 3), np.float32)
    for lo in range(0, P, _GEN_FRAMES):
        b = min(_GEN_FRAMES, P - lo)
        st = static_ref + s_lat * torch.randn((b, n_static, 3), generator=gen,
                                              device=dev)
        mo = torch.as_tensor(path[lo:lo + b], dtype=torch.float32,
                             device=dev) + s_ion * torch.randn(
            (b, M, 3), generator=gen, device=dev)
        pool[lo:lo + b] = torch.cat([st, mo], dim=1).cpu().numpy()
    del st, mo
    return dict(geo=geo, centred=centred, start=start, path=path,
                pool=pool, centres=centres, n_static=n_static)


def site_network(data):
    """The port's ``SiteNetwork``: static atoms at their reference
    positions, then the ions on their first sites; every site with its
    vertex atoms."""
    from sitator_tpu_torch import SiteNetwork, Structure
    geo, n_static = data["geo"], data["n_static"]
    ions = geo["sites"][data["centred"][data["start"]]]
    pos = np.concatenate([geo["static"], ions])
    species = np.r_[np.full(n_static, 16), np.full(len(ions), 3)]
    static = np.arange(len(pos)) < n_static
    sn = SiteNetwork(Structure(pos, species, geo["cell"]), static, ~static)
    sn.centers = geo["sites"]
    sn.vertices = list(geo["verts"])
    return sn
