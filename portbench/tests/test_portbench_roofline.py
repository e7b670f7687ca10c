"""The assignment's roofline count against a hand calculation for
``sc10k``."""
import pytest

from portbench.harness import roofline, spec


def test_sc10k_by_hand():
    cfg = spec.cell("sc10k-hop-mem")[2]
    w = roofline.assign_work(cfg, 1024)
    # 2 x 739 ions x 9261 sites x 1024 centres a frame
    assert w["product"] == (14_016_264_192 * 1024, "bfloat16")
    # 739 x (25 x 9261 atoms + (8 + 2) x 9261 sites) a frame
    assert w["core"] == (1024 * 739 * 324_135, "float32")
    # positions 10,000 x 12 B + labels and confidences 739 x 8 B a frame;
    # one block: vertex lists 9261 x 8 x 4 B, centres 1024 x 9261 x 4 B
    assert w["bytes"] == (1024 * 125_912 + 38_229_408, "bytes")
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    t, which, times = roofline.assign_bound(cfg, 1024, pk)
    assert which == "product"
    assert t == pytest.approx(14_016_264_192 * 1024 / 989e12)
    assert times["core"] == pytest.approx(1024 * 739 * 324_135 / 67e12)
    assert t * 1e6 / 1024 == pytest.approx(14.17, abs=0.01)  # us a frame


def test_bound_ignores_route_and_tiles():
    a = spec.cell("sc10k-hop-mem")[2]
    # the same sites as tetrahedra of 4 atoms of their own: the same
    # product whatever the vertices; only the core and the bytes differ
    b = dict(a, vertices_per_site=4, n_static=4 * a["n_sites"])
    assert roofline.assign_work(a, 7)["product"] == \
        roofline.assign_work(b, 7)["product"]
    assert roofline.assign_work(a, 7)["core"] != \
        roofline.assign_work(b, 7)["core"]
    assert roofline.peaks("Tesla T4") is None
