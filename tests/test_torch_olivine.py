"""The benchmark's olivine LiFePO4 configuration (``portbench/configs/
lfp10k.json``, ``portbench/geometry/olivine_li.py``) and the port's gather
route (K3) on it, on the CPU:

- the structure: 4 Li, 4 Fe, 4 P and 16 O a cell from the asymmetric unit
  and Pnma's operations; the published Li-O, Fe-O and P-O distances
  (to 1e-3 A, so a mistyped coordinate shows); every O a vertex of one or
  two Li sites, Fe and P of none; the grid neighbours of a site are its
  two [010] neighbours, b/2 apart;
- the fused-route gate: the unique-atom route (K1) is refused from 2x5x6
  cells on (``cost_ratio`` above 0.75) and the engine takes K3, while
  2x3x4 cells still tile under the bound and take K1; the run record keeps
  the gate's decision either way;
- pass 2 of ``StreamingLandmarkAnalysis`` at 2x5x6 cells with 144 ions
  (the harness's cell at small sizes) against the plain reference:
  labels equal outside the margin gate, integer tallies equal;
- the port's K3 twins against the JAX package's K3 (interpret mode) on
  these frames."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from portbench.geometry import olivine_li
from portbench.harness import spec, system
from portbench.tests._small_lfp10k import SMALL
from sitator_tpu.ops import landmark_pallas as jlp
from sitator_tpu_torch.ops import kernel_common as tkc
from sitator_tpu_torch.ops import landmark_mxu as tmx
from sitator_tpu_torch.ops import landmark_pallas as tlp

torch.set_num_threads(2)

WORKLOAD = "lfp10k-hop-mem"
SEED = 2 ** 31 + 23
# the published first-shell distances (A) of Streltsov et al. (1993)
SHELLS = {"Li": (6, [2.087, 2.171, 2.189]),
          "Fe": (6, [2.064, 2.108, 2.203, 2.251]),
          "P": (4, [1.523, 1.538, 1.556])}


def _cfg(**kw):
    return dict(spec.cell(WORKLOAD)[2], **kw)


def _min_image(a, b, cell):
    inv = np.linalg.inv(cell)
    d = (a @ inv)[:, None] - (b @ inv)[None]
    d -= np.round(d)
    d = d @ cell
    return np.sqrt((d * d).sum(-1))


def test_unit_cell_holds_the_published_atoms():
    frac = olivine_li.unit_cell(_cfg()["asymmetric_unit"])
    assert {s: len(p) for s, p in frac.items()} == dict(Li=4, Fe=4, P=4,
                                                        O=16)
    li = {tuple(p) for p in np.round(frac["Li"], 6)}
    assert li == {(0, 0, 0), (0.5, 0, 0.5), (0, 0.5, 0), (0.5, 0.5, 0.5)}


@pytest.mark.parametrize("centre", sorted(SHELLS))
def test_first_shell_distances_are_the_published_ones(centre):
    cfg = _cfg(n_cells=[1, 1, 1])
    cell = np.diag(cfg["cell_A"])
    frac = olivine_li.unit_cell(cfg["asymmetric_unit"])
    n, want = SHELLS[centre]
    r = np.sort(_min_image(frac[centre] @ cell, frac["O"] @ cell, cell),
                axis=1)
    got = r[:, :n].ravel()
    # each distance is one of the published ones, and each one occurs
    near = np.abs(got[:, None] - np.asarray(want)[None])
    assert near.min(1).max() < 1e-3, got
    assert (near < 1e-3).any(0).all()
    assert r[:, n].min() > r[:, n - 1].max() + 0.3     # the shell is closed


def test_octahedra_share_edges_only_and_fe_p_are_no_vertex():
    geo = olivine_li.build(_cfg(**SMALL))
    st = geo["species_start"]
    count = np.bincount(geo["verts"].ravel(), minlength=len(geo["static"]))
    assert len(geo["static"]) == SMALL["n_static"]
    assert len(geo["sites"]) == SMALL["n_sites"]
    assert geo["verts"].shape == (SMALL["n_sites"], 6)
    assert (count[:st["O"]] == 0).all()                  # Fe, P
    assert set(np.unique(count[st["O"]:]).tolist()) == {1, 2}
    # each site's 6 vertices are O within 2.3 A of it
    d = np.linalg.norm(_wrap(geo["static"][geo["verts"]]
                             - geo["sites"][:, None], geo["cell"]), axis=-1)
    assert d.max() < 2.3


def _wrap(d, cell):
    inv = np.linalg.inv(cell)
    f = d @ inv
    return (f - np.round(f)) @ cell


def test_grid_neighbours_are_the_two_b_neighbours():
    cfg = _cfg(**SMALL)
    geo = olivine_li.build(cfg)
    centred, nbr = system.centred_sites(geo, cfg["centred_block"])
    assert len(centred) == SMALL["n_centres"]
    sites = geo["sites"][centred]
    b = cfg["cell_A"][1]
    assert (nbr[:, :2] < 0).all() and (nbr[:, 4:] < 0).all()   # x and z
    for k in range(len(centred)):
        for j in nbr[k][nbr[k] >= 0]:
            gap = sites[j] - sites[k]
            assert np.allclose(np.abs(gap), [0, b / 2, 0], atol=1e-9)
    # chains of 10 along b: two ends with one neighbour each
    assert np.bincount((nbr >= 0).sum(1)).tolist() == [0, 48, 192]


def _gate(n_cells):
    geo = olivine_li.build(_cfg(n_cells=n_cells))
    vmask = np.ones(geo["verts"].shape, bool)
    kw = dict(midpoint=4.0, steepness=3.0, cutoff_shape="logistic_r2",
              static_ref=geo["static"], drift_budget=1.0)
    basis, gate = tmx._engine_gate(geo["verts"], vmask, geo["sites"],
                                   geo["cell"], **kw)
    public = tmx.prepare_engine_basis(geo["verts"], vmask, geo["sites"],
                                      geo["cell"], **kw)
    assert (public is None) == (basis is None)
    return basis, gate


def test_gate_refuses_k1_on_olivine():
    basis, gate = _gate([2, 5, 6])
    assert basis is None
    assert gate["route"] == "gather" and gate["cost_ratio"] > 0.75
    assert gate["n_sites"] == 240 and gate["vertex_slots"] == 6
    assert gate["max_cost_ratio"] == 0.75


def test_gate_takes_k1_on_small_olivine():
    basis, gate = _gate([2, 3, 4])
    assert basis is not None
    assert gate["route"] == "mxu" and gate["cost_ratio"] <= 0.75
    assert gate["s_tile"] == basis["s_tile"] and gate["UP"] == basis["UP"]


def test_pass2_on_olivine_equals_the_reference():
    from portbench.harness.cell import run_cell
    from sitator_tpu_torch.util import timing
    res, _ = run_cell(WORKLOAD, SEED, 0.2, False, device="cpu",
                      overrides=SMALL)
    c = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"], c
    assert c["route"] == "gather"
    assert c["labels_off"] == 0 and c["stats_off"] == 0 and c["jumps"] >= 1
    rec = timing.recent_runs()[-1]
    assert rec["gate"]["route"] == "gather"
    assert rec["device"] is None      # no device brackets on the CPU


def _frames(n):
    """``n`` frames of the small cell's pool, its static atoms, sites and
    centres, as the harness makes them."""
    _, _, cfg, traffic = spec.cell(WORKLOAD, SMALL)
    data = system.make(cfg, traffic, SEED, torch.device("cpu"))
    ns = data["n_static"]
    pool = data["pool"][:n]
    return (cfg, data["geo"], pool[:, ns:].copy(), pool[:, :ns].copy(),
            data["centres"])


def _margin(mobile, static, geo, centres, cfg):
    """float64 top-1 minus top-2 similarity and top-1, with f32 centres."""
    from portbench.reference import landmark_assign as ref
    lv = ref.landmark_vectors(
        torch.as_tensor(mobile, dtype=torch.float64),
        torch.as_tensor(static, dtype=torch.float64),
        torch.as_tensor(geo["cell"]), torch.as_tensor(
            geo["verts"], dtype=torch.long), cfg).numpy()
    lv /= np.linalg.norm(lv, axis=-1, keepdims=True)
    sims = lv @ centres.astype(np.float64).T
    top = -np.sort(-sims, axis=-1)[..., :2]
    return top[..., 0] - top[..., 1], top[..., 0]


@pytest.mark.parametrize("twin", ["plain", "card_partition"])
def test_k3_twins_match_the_jax_package_on_olivine(twin):
    cfg, geo, mobile, static, centres = _frames(2)
    verts = geo["verts"]
    vmask = np.ones(verts.shape, bool)
    kcell = tkc.kernel_cell(geo["cell"]).numpy()
    thr = float(cfg["assignment_threshold"])
    kw = dict(midpoint=4.0, steepness=3.0, threshold=thr, s_tile=128,
              cutoff_shape="logistic_r2")
    M = mobile.shape[1]
    if twin == "plain":
        labels, confs = tlp.fused_assign_blocks(
            torch.from_numpy(mobile), torch.from_numpy(static), verts, vmask,
            kcell, centres, full_mask=True, **kw)
    else:
        args = tlp._gather_inputs(
            torch.from_numpy(mobile), torch.from_numpy(static), verts, vmask,
            kcell, centres, full_mask=True, **kw)
        labels, confs, _, _ = tlp._gather_route_plain(**args)
        labels, confs = labels[:, :M], confs[:, :M]
    want_l, want_c = jlp.fused_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), jnp.asarray(kcell), jnp.asarray(centres),
        interpret=True, full_mask=True, **kw)
    margin, top1 = _margin(mobile, static, geo, centres, cfg)
    np.testing.assert_allclose(confs.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-2)
    gate = (margin <= 8e-3) | (np.abs(top1 - thr) <= 1e-2)
    assert (~gate).sum() > 0.9 * gate.size
    np.testing.assert_array_equal(labels.numpy()[~gate],
                                  np.asarray(want_l)[~gate])
    assert (labels.numpy() >= 0).mean() > 0.9    # the ions sit on sites
