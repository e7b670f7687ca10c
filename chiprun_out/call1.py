"""Runs chip_smoke.py's device, build, K1s and bench phases alone, so that
the bench tools can be read on the card without the other phases.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chiprun_out/call1.py
"""
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

t0 = time.perf_counter()
cs.phase_device()
cs.phase_build()
print("skew", cs.phase_skew("cuda"), flush=True)
print("bench", cs.phase_bench("cuda"), flush=True)
print(f"CALL1-OK {time.perf_counter() - t0:.1f} s", flush=True)
