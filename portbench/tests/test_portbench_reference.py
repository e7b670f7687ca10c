"""The plain reference against the port's plain routes at small sizes:
labels equal outside the margin gate, confidences and sums close, and the
recount equal to the port's int64 oracle."""
import numpy as np
import pytest
import torch

from _small import SEED, SIZES, WORKLOADS
from portbench.harness import cell, sources, spec, system
from portbench.reference.tally import tally


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_reference_against_port_plain_route(workload, tmp_path):
    _, _, cfg, traffic = spec.cell(workload, SIZES[WORKLOADS[workload]])
    dev = torch.device("cpu")
    data = system.make(cfg, traffic, SEED, dev)
    ref = cell.reference(cfg, data, dev)
    source, close = sources.open_source(traffic, data["pool"],
                                        str(tmp_path))
    try:
        eng = cell.make_engine(cfg, dev)
        p = cell.one_pass(eng, system.site_network(data),
                          sources.Cycled(source, cfg["n_frames"]),
                          data["centres"], str(tmp_path / "labels.npy"))
    finally:
        close()
    assert p["route"] == cfg["route"]
    got = np.load(p["labels_path"])
    order = np.arange(len(got)) % len(data["pool"])
    want = ref["labels"][order]
    open_ = ref["margin"][order] > cfg["limits"]["margin_gate"]
    assert open_.mean() > 0.99
    assert not ((got != want) & open_).any()
    K = cfg["n_centres"]
    recount = tally(np.where(open_, want, got), K)
    st = p["state"]
    for k in ("occ", "n_ij", "lag_sum", "res_sum", "res_cnt", "carry_last",
              "carry_res"):
        assert np.array_equal(st[k], recount[k]), k
    assert int(st["mo_viol"]) == int(recount["mo_viol"])
    if np.array_equal(got, want):
        s = ref["pass_sums"]
        np.testing.assert_allclose(st["conf"][:K], s["conf"][:K],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st["cos"][:K], s["cos"][:K], atol=1e-4)
        np.testing.assert_allclose(st["sin"][:K], s["sin"][:K], atol=1e-4)


def _labels_with_gaps(rng, F, M, K):
    lab = rng.integers(0, K, size=(F, M))
    stay = rng.random((F, M)) < 0.8
    for f in range(1, F):
        lab[f] = np.where(stay[f], lab[f - 1], lab[f])
    lab[rng.random((F, M)) < 0.15] = -1
    lab[:5, 0] = -1
    lab[:, 1] = -1                      # an ion never assigned
    lab[3, 2:4] = lab[3, 4]             # a shared site
    return lab.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recount_equals_port_int64_oracle(seed):
    from sitator_tpu_torch.ops.jumps import jump_stats_exact
    rng = np.random.default_rng(seed)
    F, M, K = 300, 9, 7
    lab = _labels_with_gaps(rng, F, M, K)
    got = tally(lab, K)
    want = jump_stats_exact(lab, K, device="cpu", block_frames=64)
    for mine, theirs in (("n_ij", "n_ij"), ("lag_sum", "lag_sum"),
                         ("res_sum", "res_sum"), ("res_cnt", "res_cnt")):
        assert np.array_equal(got[mine], np.asarray(want[theirs])), mine
    assert np.array_equal(got["occ"][:K], np.asarray(want["occ_counts"]))
    assert got["occ"][K] == (lab < 0).sum()
    assert np.array_equal(got["carry_last"], np.asarray(want["last_sites"]))
    assert np.array_equal(got["carry_res"], np.asarray(want["last_res"]))
    per = [np.bincount(r[r >= 0], minlength=K) for r in lab]
    assert got["mo_viol"] == sum(int((c > 1).sum()) for c in per)
    assert got["n_ij"].sum() > 0
