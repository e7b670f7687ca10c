"""Shared helpers of ``tests/test_torch_examples_{a,b,c,d}.py``: each
walkthrough of ``examples/`` and its port in ``sitator_tpu_torch/examples/``
run side by side in subprocesses, as a user runs them, and their printed
lines compared.

The reference runs as ``python examples/<name>.py`` (it pins the CPU
itself).  The port runs as ``python -m sitator_tpu_torch.examples.<name>
--device cpu`` in an interpreter where ``jax``, ``jaxlib`` and
``sitator_tpu`` cannot be imported, on one thread, with ``TMPDIR`` set to
the test's own directory.

The comparison is ``sitator_tpu_torch/examples/_parity.py``'s
``differences`` against the reference: the same lines, each not exempt
there the same after paths under a temporary directory are masked (the same
words, integers equal and floats equal to the last printed digit).
"""
import os
import subprocess
import sys
import tempfile
import textwrap

from sitator_tpu_torch.examples._parity import differences
from tests.test_examples import EXAMPLES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600

GUARD = textwrap.dedent("""
    import importlib.abc
    import runpy
    import sys

    name, *also = sys.argv[1].split(",")
    BLOCKED = {"jax", "jaxlib", "sitator_tpu", *also}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    sys.argv = [name] + sys.argv[2:]
    runpy.run_module(f"sitator_tpu_torch.examples.{name}",
                     run_name="__main__")
""")


def start_reference(name):
    env = dict(os.environ)
    env.pop("SITATOR_EXAMPLES_PLATFORM", None)
    return subprocess.Popen(
        [sys.executable, os.path.join("examples", name)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_port(name, tmp, *args, blocked=()):
    """The port's ``name`` on the CPU with ``args``, in an interpreter that
    cannot import JAX, the reference, nor any of ``blocked``."""
    # one thread: the test runs beside others, and a first multi-threaded
    # math call of CPU torch can be inexact (tests/_torch_common.py)
    env = dict(os.environ, TMPDIR=str(tmp), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-c", GUARD,
         ",".join([name.removesuffix(".py"), *blocked]), "--device", "cpu",
         *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish(proc, label):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, (
        f"{label} exited {proc.returncode}\n--- stdout ---\n{out[-4000:]}"
        f"\n--- stderr ---\n{err[-4000:]}")
    return out


def check_example(name, tmp_path, blocked=()):
    """Run both sides at once (the port unable to import ``blocked`` as
    well), assert the reference's key lines on both and the line-by-line
    rule."""
    ref = start_reference(name)
    port = start_port(name, tmp_path, blocked=blocked)
    ref_out = finish(ref, f"examples/{name}")
    port_out = finish(port, f"sitator_tpu_torch/examples/{name}")
    for key in EXAMPLES[name]:
        assert key in ref_out, (name, key)
        assert key.replace("/tmp/", f"{tmp_path}/") in port_out, (
            f"{name}: expected {key!r} in the port's output\n{port_out}")
    roots = ["/tmp", tempfile.gettempdir(), str(tmp_path)]
    bad = differences(name, ref_out, port_out, roots)
    assert not bad, f"{name}:\n" + "\n".join(bad)
