"""The port's walkthroughs against the reference's, line by line (the
rule and the exempt lines: ``sitator_tpu_torch/examples/_parity.py``),
also the three whose reference needs ``sklearn`` or ``tensorstore`` run
by the port where neither (nor ``networkx``) can be imported; the
reference's K1 and the port's on ``multichip_mesh``."""
import pytest

from tests._torch_examples import check_example


@pytest.mark.parametrize("name", ["diffusion_kinetics.py",
                                  "multichip_mesh.py",
                                  "density_sites.py"])
def test_example_matches_reference(name, tmp_path):
    check_example(name, tmp_path)


# what the reference's typing, bottleneck and zarr steps import, and the
# machine with the card lacks
LIBRARIES = ["sklearn", "tensorstore", "networkx"]


@pytest.mark.parametrize("name", ["fcc_tet_oct.py", "streaming_and_typing.py",
                                  "zarr_and_smeared_soap.py"])
def test_example_without_optional_library(name, tmp_path):
    """In an interpreter that cannot import ``sklearn``, ``tensorstore``
    or ``networkx`` (a machine that lacks them) the walkthrough runs every
    step — the typing, and the stream off a zarr store — and prints every
    key line of the reference's run (``tests/test_examples.py``) and every
    other line by the parity rule."""
    check_example(name, tmp_path, blocked=LIBRARIES)


def test_mesh_example_routes_differ_only_inside_the_gate(tmp_path):
    """On the card ``multichip_mesh`` streams through K1 (bf16
    similarities), on the CPU through the dense route (f32), and the two
    can print other jumps.  On the example's system the reference's own K1
    (``landmark_mxu.py::_kernel`` in interpret mode) and K1's plain twin
    in the port give the same labels outside the precision gate
    (``tools/bench.py::gated``) and the same jumps, and so do the two
    packages' dense routes; every label that K1's route gives otherwise
    than the dense route lies inside the gate, as
    ``chip_smoke.py::phase_examples`` requires of the card."""
    import numpy as np

    from sitator_tpu.landmark import StreamingLandmarkAnalysis as JaxStreaming
    from sitator_tpu_torch.examples import multichip_mesh
    from sitator_tpu_torch.examples._parity import gate_margins
    from sitator_tpu_torch.landmark import StreamingLandmarkAnalysis
    from sitator_tpu_torch.tools.bench import gated
    from tests._torch_common import networks_of

    md, seeds = multichip_mesh.system()
    ref_seeds, _ = networks_of(md, centers=seeds.centers,
                               vertices=seeds.vertices)
    labels, jumps, centers = {}, {}, {}
    for side, fused in (("reference", True), ("reference", False),
                        ("port", True), ("port", False)):
        path = str(tmp_path / f"labels_{side}_{fused}.npy")
        kw = dict(multichip_mesh.ENGINE, store_labels=path, use_fused=fused,
                  verbose=False)
        if side == "port":
            sla, sn = StreamingLandmarkAnalysis(**kw, device="cpu"), seeds
        else:
            sla, sn = JaxStreaming(**kw, interpret=fused), ref_seeds
        centers[side, fused] = np.asarray(sla.fit_centers(sn, md.traj))
        jumps[side, fused] = int(np.asarray(
            sla.run(sn, md.traj, centers=centers[side, fused]).n_ij).sum())
        labels[side, fused] = np.load(path)

    def rows_outside_gate(a, b):
        rows = np.argwhere(labels[a] != labels[b])
        if not len(rows):
            return rows, rows
        margin, top1 = gate_margins(md, seeds, centers["port", True], rows,
                                    "cpu", **multichip_mesh.ENGINE)
        return rows, rows[~gated(margin, top1)]

    for fused in (True, False):
        _, outside = rows_outside_gate(("reference", fused), ("port", fused))
        assert not len(outside), (fused, outside[:4])
        assert jumps["reference", fused] == jumps["port", fused], fused
    rows, outside = rows_outside_gate(("port", True), ("port", False))
    assert len(rows) and not len(outside), (len(rows), outside[:4])
