"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, ``portbench/`` and
``sitator_tpu_torch/``.  The cell's configuration, traffic mix, spans and
metric readers are found by name from ``BENCHMARK.json``.  With ``--trace
0`` it times whole passes of ``StreamingLandmarkAnalysis.run`` until
``--seconds`` have passed and reports the cell's end-to-end metrics; with
``--trace 1`` it profiles one pass after an untraced one and reports the
per-layer metrics.  Either way it then holds what the passes produced to
the plain reference (``portbench/reference/``).  The last line of standard
output is one JSON object; the compared numbers and their limits are the
last lines of standard error and the last key of that object.

Exits 2, printing no result, without a card (or with fewer than the cell
asks for) or without the port beside this directory; 3 when the process
has loaded the JAX stack or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the program's build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / sub)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import guard, spec
    try:
        _, work, _, _ = spec.cell(args.workload)
    except (OSError, KeyError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    t_interp = time.perf_counter()
    try:
        import sitator_tpu_torch
    except ImportError as e:
        print(f"portbench: the port is not beside portbench/: {e}",
              file=sys.stderr)
        return 2
    if Path(sitator_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print("portbench: sitator_tpu_torch was found outside the checkout "
              f"({sitator_tpu_torch.__file__})", file=sys.stderr)
        return 2
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(work["chips"]):
        print(f"portbench: the cell needs {work['chips']} CUDA card(s); "
              f"found {found}", file=sys.stderr)
        return 2
    from portbench.harness.cell import run_cell
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda",
                             t_start=T_START,
                             marks=[("interpreter", t_interp)])
    bad = guard.loaded()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} {c['op']} {c['limit']}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
