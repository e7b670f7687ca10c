"""The port's walkthroughs against the reference's, line by line (the rule
and the exempt lines: ``sitator_tpu_torch/examples/_parity.py``)."""
import pytest

from tests._torch_examples import check_example


@pytest.mark.parametrize("name", ["temperature_series.py",
                                  "formats_and_lattice_mapping.py",
                                  "npt_variable_cell.py"])
def test_example_matches_reference(name, tmp_path):
    check_example(name, tmp_path)


def test_line_rule_reports_each_kind_of_difference():
    """The comparison the parity tests and the card's run rest on
    (``sitator_tpu_torch/examples/_parity.py``): a changed integer, a
    float changed in its last printed digit, changed words and a missing
    line are each reported; a path under a temporary directory and an
    exempt line are not.  Against the card a float may move one unit in
    its last printed digit and no more, an integer not at all, and each
    comparison exempts only its own lines."""
    from sitator_tpu_torch.examples._parity import CARD, CARD_FLOAT_UNITS
    from tests._torch_examples import differences
    ref = ("sites: 28, jumps observed: 1429\n"
           "D_tracer     = 0.09986 ± 0.018 Å²/ps\n"
           "saved to /tmp/walkthrough_result.npz\n"
           "KMC closure: max |P_resampled - P_measured| = 0.0042 (24 walkers"
           " x 16000 frames)\n")
    assert differences("diffusion_kinetics.py", ref, ref, ["/tmp"]) == []
    moved = ref.replace("/tmp/", "/tmp/pytest-7/t0/").replace(
        "0.0042", "0.0084")
    assert differences("diffusion_kinetics.py", ref, moved, ["/tmp"]) == []
    for a, b, kind in (("1429", "1430", "numbers"),
                       ("0.09986", "0.09987", "numbers"),
                       ("observed", "seen", "words")):
        bad = differences("diffusion_kinetics.py", ref, ref.replace(a, b),
                          ["/tmp"])
        assert len(bad) == 1 and f"{kind} differ" in bad[0], bad
    short = ref.split("\n", 1)[1]
    assert differences("diffusion_kinetics.py", ref, short, ["/tmp"]) == [
        "4 lines against 3"]

    def on_card(a, b, name="diffusion_kinetics"):
        return differences(name, ref, ref.replace(a, b), ["/tmp"],
                           against=CARD, float_units=CARD_FLOAT_UNITS)
    assert CARD_FLOAT_UNITS == 1
    assert on_card("0.09986", "0.09987") == []
    assert on_card("0.09986", "0.09985") == []
    for a, b, what in (("0.09986", "0.09988", "float"),
                       ("1429", "1430", "integer")):
        bad = on_card(a, b)
        assert len(bad) == 1 and f"({what} {a} / {b})" in bad[0], bad
    assert on_card("0.0042", "0.0084") == []
    devices = "devices: 8 x cpu\n"
    assert differences("multichip_mesh.py", devices, "devices: 8 x cuda\n",
                       ["/tmp"], against=CARD) == []
    assert len(differences("multichip_mesh.py", devices,
                           "devices: 8 x cuda\n", ["/tmp"])) == 1
