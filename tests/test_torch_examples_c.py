"""The port's walkthroughs against the reference's, line by line (the
rule and the exempt lines: ``sitator_tpu_torch/examples/_parity.py``),
and the port's refusal to run on the CPU when a card was asked for."""
import os
import subprocess
import sys

import pytest

from tests._torch_examples import REPO, check_example


@pytest.mark.parametrize("name", ["fcc_tet_oct.py",
                                  "streaming_and_typing.py",
                                  "landmark_walkthrough.py"])
def test_example_matches_reference(name, tmp_path):
    check_example(name, tmp_path)


def test_example_without_a_card_exits_with_a_message(tmp_path):
    """The counterpart of ``test_example_overrides_hostile_platform_pin``:
    with no card visible and no ``--device``, an example does not go on on
    the CPU; it exits non-zero and says why."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, os.path.join("sitator_tpu_torch", "examples",
                                      "landmark_walkthrough.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device is visible" in proc.stderr
    assert "--device cpu" in proc.stderr
    assert proc.stdout == ""
    assert not (tmp_path / "walkthrough_result.npz").exists()
