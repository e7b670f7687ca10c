"""Line coverage for ``sitator_tpu_torch`` without external tooling.

The environment has no coverage.py, so this uses Python 3.12's
``sys.monitoring`` with per-line DISABLE (each line reports once, so the
overhead after warm-up is near zero) to record which of the port's lines
the tests execute, then diffs against the set of *executable* lines
(every code object's ``co_lines()``, collected by compiling each source
file).

Usage (CPU, from the repo root; run it as a file, since ``python3 -m``
imports the package before the tracing starts):

    JAX_PLATFORMS=cpu python3 sitator_tpu_torch/tools/line_coverage.py \
        [--cov-out PATH] [pytest args...]

(pytest arguments that start with ``-`` go after ``--``; without any, the
``tests/test_torch_*`` files run.)  Prints a
per-file table of uncovered executable lines and writes the raw
hit/executable sets to the JSON (default
``sitator_tpu_torch_coverage.json`` in the temporary directory) for
drill-down.  Traced scope is the ``sitator_tpu_torch`` package only
(tests, tools' callers and the reference are not traced).

Caveats: lines of the CUDA wrappers that run only on a card read as
uncovered on a CPU host (their plain versions run instead); this measures
Python-level reachability.  SUBPROCESSES ARE NOT TRACED: code exercised
only through subprocess tests (``__main__.py``, the example walkthroughs,
the CLI when spawned, the multi-process ranks) reads as uncovered here even
though it runs in CI — check for a subprocess test before calling a gap
real.
"""
import argparse
import importlib.util
import json
import os
import pathlib
import sys
import tempfile

# A deliberately free tool id (NOT sys.monitoring.COVERAGE_ID == 1): this
# collector must coexist with any real coverage tool that claims slot 1.
TOOL_ID = 4
PACKAGE = "sitator_tpu_torch"
ROOT = str(pathlib.Path(__file__).resolve().parents[2])


def executable_lines(path: pathlib.Path):
    """All line numbers with generated bytecode, via recursive co_lines."""
    code = compile(path.read_text(), str(path), "exec")
    lines = set()
    stack = [code]
    while stack:
        co = stack.pop()
        for _, _, ln in co.co_lines():
            # ln 0 = interpreter prologue bytecode (RESUME etc.) that never
            # fires a LINE event — counting it costs every file one phantom
            # "missing" line
            if ln:
                lines.add(ln)
        for const in co.co_consts:
            if isinstance(const, type(code)):
                stack.append(const)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m sitator_tpu_torch.tools.line_coverage",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--cov-out", default=os.path.join(
        tempfile.gettempdir(), "sitator_tpu_torch_coverage.json"))
    ap.add_argument("pytest_args", nargs="*", default=[])
    args = ap.parse_args(argv)

    # locate the package WITHOUT importing it — module-level lines must
    # execute after monitoring is enabled or every __init__ reads 0%
    if PACKAGE in sys.modules:
        print(f"line_coverage: {PACKAGE} was imported before the tracing "
              "started; run this file as a script (python3 "
              "sitator_tpu_torch/tools/line_coverage.py)", file=sys.stderr)
        return 2
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    spec = importlib.util.find_spec(PACKAGE)
    pkg_dir = str(pathlib.Path(spec.origin).parent)
    # the trailing "/": siblings sharing the prefix don't match
    pkg_prefix = pkg_dir.rstrip("/") + "/"
    hits = {}  # filename -> set of lines

    mon = sys.monitoring
    mon.use_tool_id(TOOL_ID, "line_coverage")

    def on_line(code, line):
        fn = code.co_filename
        if not fn.startswith(pkg_prefix):
            return mon.DISABLE
        hits.setdefault(fn, set()).add(line)
        return mon.DISABLE  # one report per line is enough

    mon.register_callback(TOOL_ID, mon.events.LINE, on_line)
    mon.set_events(TOOL_ID, mon.events.LINE)
    try:
        import pytest
        rc = pytest.main(args.pytest_args or sorted(
            str(p) for p in pathlib.Path(ROOT, "tests").glob(
                "test_torch_*.py")) + ["-q", "-p", "no:cacheprovider"])
    finally:
        mon.set_events(TOOL_ID, 0)
        mon.register_callback(TOOL_ID, mon.events.LINE, None)
        mon.free_tool_id(TOOL_ID)

    report = {}
    rows = []
    for path in sorted(pathlib.Path(pkg_dir).rglob("*.py")):
        fn = str(path)
        execl = executable_lines(path)
        hit = hits.get(fn, set()) & execl
        missing = sorted(execl - hit)
        rel = str(path.relative_to(pathlib.Path(pkg_dir).parent))
        report[rel] = {"executable": len(execl), "hit": len(hit),
                       "missing": missing}
        if execl:
            rows.append((len(missing), rel, len(hit), len(execl)))

    tot_hit = sum(r["hit"] for r in report.values())
    tot_exec = sum(r["executable"] for r in report.values())
    rows.sort(reverse=True)
    print(f"\n=== line coverage: {tot_hit}/{tot_exec} "
          f"({100.0 * tot_hit / max(tot_exec, 1):.1f}%) ===")
    print(f"{'missing':>8}  {'cov%':>6}  file")
    for n_miss, rel, n_hit, n_exec in rows:
        if n_miss == 0:
            continue
        print(f"{n_miss:>8}  {100.0 * n_hit / n_exec:>5.1f}%  {rel}")
    with open(args.cov_out, "w") as fh:
        json.dump(report, fh)
    print(f"# wrote {args.cov_out}")
    return int(rc)


if __name__ == "__main__":
    # run as a file: its own directory on sys.path would shadow top-level
    # modules of the checkout (bench.py) for the tests it runs
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.exit(main())
