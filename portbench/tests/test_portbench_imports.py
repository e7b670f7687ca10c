"""What ``run.py`` and the reference load: never ``jax`` or the JAX package
``sitator_tpu`` (top-level names compared whole, so the port
``sitator_tpu_torch`` is not it), and the reference nothing of the port."""
import os
import shutil
import subprocess
import sys
import textwrap

from portbench.harness import guard, spec

ROOT = spec.ROOT

BLOCK = textwrap.dedent("""
    import importlib.abc, sys
    BANNED = {"jax", "jaxlib", "flax", "sitator_tpu"}
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                raise ImportError(f"blocked: {name}")
            return None
    sys.meta_path.insert(0, Block())
    sys.path.insert(0, %r)
""") % str(ROOT)


def _py(code, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_guard_compares_whole_names():
    assert guard.loaded({"sitator_tpu_torch": 1,
                         "sitator_tpu_torch.ops": 1, "jaxtyping": 1}) == []
    assert guard.loaded({"sitator_tpu.ops.jumps": 1, "jax.numpy": 1}) == [
        "jax", "sitator_tpu"]


def test_run_path_loads_no_jax_or_jax_package():
    code = BLOCK + textwrap.dedent("""
        import torch
        torch.set_num_threads(2)
        sys.path.insert(0, "portbench/tests")
        from _small import SEED, SIZES
        import portbench.run
        from portbench.harness.cell import run_cell
        from portbench.harness import guard
        for wl, cfg in (("sc10k-hop-h5", "sc10k"),
                        ("sc10k-hop-mem", "sc10k")):
            for tr in (False, True):
                res, _ = run_cell(wl, SEED, 0.2, tr, device="cpu",
                                  overrides=SIZES[cfg])
                assert res["correct"], res["checks"]
        import portbench.control
        bad = guard.loaded()
        assert not bad, bad
        tops = {m.split(".")[0] for m in sys.modules}
        assert "sitator_tpu_torch" in tops and "sitator_tpu" not in tops
        print("RUN-PATH-OK")
    """)
    proc = _py(code)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "RUN-PATH-OK" in proc.stdout


def test_reference_loads_nothing_of_the_port():
    code = BLOCK + textwrap.dedent("""
        import portbench.reference.landmark_assign
        import portbench.reference.tally
        tops = {m.split(".")[0] for m in sys.modules}
        bad = tops & {"sitator_tpu_torch", "sitator_tpu", "jax", "jaxlib",
                      "flax"}
        assert not bad, bad
        print("REFERENCE-OK")
    """)
    proc = _py(code)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "REFERENCE-OK" in proc.stdout


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sc10k-hop-mem",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_run_beside_no_port_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sc10k-hop-mem",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
