"""Shared example bootstrap.

The walkthroughs run their engines on ``--device`` (``cuda`` or ``cpu``,
default ``cuda``: the rule of the port's command line).  Without a card an
example asked for ``cuda`` exits 1 with the reason on stderr; it never goes
on on the CPU.  ``--device cpu`` runs it on the host.

Run from a source checkout without installing, an example finds the
package through :func:`_ensure_importable`, which puts the repo root (this
file's parent's parent's parent) on ``sys.path``.

The three examples that need ``sklearn`` or ``tensorstore`` ask
:func:`has` whether the library can be imported; where it cannot, they
leave out the steps that need it and name each on a line of its own
(:func:`left_out`).
"""
import argparse
import importlib
import os
import sys


def _ensure_importable():
    """Running from a source checkout without installing: put the repo
    root on sys.path."""
    try:
        import sitator_tpu_torch  # noqa: F401
    except ImportError:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))


_ensure_importable()


def parse_args(prog, doc, argv=None, configure=None):
    """The example's arguments: ``--device``, and whatever ``configure(ap)``
    adds."""
    ap = argparse.ArgumentParser(
        prog=f"python3 -m sitator_tpu_torch.examples.{prog}",
        description=doc.strip().split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines run (default cuda; without a "
                         "card the example exits 1)")
    if configure is not None:
        configure(ap)
    return ap.parse_args(argv)


def device_missing(prog, device):
    """1, after the reason on stderr, when ``device`` is ``cuda`` and no
    card is visible; else 0."""
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device is visible (torch.cuda.is_available() "
              "is false); pass --device cpu to run on the host",
              file=sys.stderr)
        return 1
    return 0
