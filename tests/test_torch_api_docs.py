"""``docs/API_TORCH.md`` stays in sync with the port's live public surface
and covers every public name of the reference's page, module by module
(``sitator_tpu_torch/tools/gen_api_docs.py``); every documented module of
the port exports what the reference's exports; the port's line-coverage
tool traces the port and nothing else."""
import importlib
import json
import os
import re
import subprocess
import sys

import pytest

from sitator_tpu_torch.tools import gen_api_docs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(name):
    with open(os.path.join(REPO, "docs", name)) as f:
        return f.read()


def _sections(text, package):
    """{module with the package written ``<pkg>``: documented names}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"^#{2,3} `([\w.]+)`", line)
        if m:
            cur = out.setdefault("<pkg>" + m.group(1)[len(package):], set())
            continue
        m = re.match(r"^- \*\*`(?:class )?(\w+)", line)
        if m and cur is not None:
            cur.add(m.group(1))
    return out


def test_api_torch_docs_fresh():
    assert _read("API_TORCH.md") == gen_api_docs.generate(), (
        "docs/API_TORCH.md is stale — regenerate with "
        "`python3 -m sitator_tpu_torch.tools.gen_api_docs`")


def test_api_torch_docs_cover_every_reference_name():
    ref = _sections(_read("API.md"), "sitator_tpu")
    port = _sections(_read("API_TORCH.md"), "sitator_tpu_torch")
    assert set(port) == set(ref)
    missing = {mod: sorted(names - port[mod])
               for mod, names in ref.items() if names - port[mod]}
    assert not missing, missing


@pytest.mark.parametrize(
    "module", [m for m, _ in gen_api_docs.MODULES] + gen_api_docs.OPS_MODULES)
def test_port_module_exports_the_reference_names(module):
    """Every name in the ``__all__`` of a documented module of the
    reference is in the port's ``__all__`` of the same module, the
    submodules included (``sitator_tpu.ops`` lists ``mcl``; the docs skip
    modules, so this is where a missing one shows)."""
    port = importlib.import_module(module)
    ref = importlib.import_module(
        "sitator_tpu" + module[len("sitator_tpu_torch"):])
    ref_names = set(getattr(ref, "__all__", ()))
    port_names = set(getattr(port, "__all__", ()))
    assert ref_names <= port_names, sorted(ref_names - port_names)
    for name in ref_names:
        assert getattr(port, name, None) is not None, name


def test_line_coverage_traces_the_port_only(tmp_path):
    out = tmp_path / "coverage.json"
    proc = subprocess.run(
        [sys.executable, os.path.join("sitator_tpu_torch", "tools",
                                      "line_coverage.py"),
         "--cov-out", str(out), "--", "tests/test_torch_pbc.py", "-q",
         "-p", "no:cacheprovider", "-p", "no:xdist"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "=== line coverage:" in proc.stdout
    report = json.loads(out.read_text())
    assert report["sitator_tpu_torch/ops/pbc.py"]["hit"] > 0
    assert "sitator_tpu_torch/examples/_common.py" in report
    assert all(k.startswith("sitator_tpu_torch/") for k in report), [
        k for k in report if not k.startswith("sitator_tpu_torch/")][:5]
    # pbc's tests never reach the examples
    assert report["sitator_tpu_torch/examples/_common.py"]["hit"] == 0


def test_line_coverage_refuses_an_imported_package():
    """Run through ``python -m`` the package is imported before the
    tracing starts; the tool says so and exits 2."""
    proc = subprocess.run(
        [sys.executable, "-m", "sitator_tpu_torch.tools.line_coverage"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "run this file as a script" in proc.stderr
