"""The port's walkthroughs against the reference's, line by line (the
rule and the exempt lines: ``sitator_tpu_torch/examples/_parity.py``),
and the port's examples directory against ``examples/``."""
import os

import pytest

from tests._torch_examples import EXAMPLES, REPO, check_example


@pytest.mark.parametrize("name", ["zarr_and_smeared_soap.py",
                                  "msm_validation.py",
                                  "structure_screening.py"])
def test_example_matches_reference(name, tmp_path):
    check_example(name, tmp_path)


def test_every_example_is_ported():
    """Every walkthrough of ``examples/`` has its port under
    ``sitator_tpu_torch/examples/`` and the port has no other, so every
    port is under a parity test."""
    def scripts(d):
        return {f for f in os.listdir(os.path.join(REPO, d))
                if f.endswith(".py") and not f.startswith("_")}
    ported = scripts(os.path.join("sitator_tpu_torch", "examples"))
    assert ported == scripts("examples") == set(EXAMPLES)
