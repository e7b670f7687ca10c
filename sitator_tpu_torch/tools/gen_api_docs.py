"""Generate docs/API_TORCH.md from the port's live package surface.

Walks every public module's ``__all__`` (the modules of the reference's
``tools/gen_api_docs.py``, under ``sitator_tpu_torch``), records
signatures and first docstring lines, and writes one markdown reference.
It imports only the port.  Run from the root of a checkout:

    python3 -m sitator_tpu_torch.tools.gen_api_docs [OUT]

``tests/test_torch_api_docs.py`` holds the committed file to a fresh
generation (regenerate after any change of the port's public surface).
"""
from __future__ import annotations

import importlib
import inspect
import os
import sys

MODULES = [
    ("sitator_tpu_torch", "Core data model"),
    ("sitator_tpu_torch.io", "Trajectory IO and synthetic generators"),
    ("sitator_tpu_torch.voronoi", "Site seeding"),
    ("sitator_tpu_torch.landmark", "Landmark engines"),
    ("sitator_tpu_torch.landmark.cluster", "Clustering backends"),
    ("sitator_tpu_torch.dynamics", "Dynamics / kinetics post-processing"),
    ("sitator_tpu_torch.network", "Network analysis and merging"),
    ("sitator_tpu_torch.site_descriptors", "Descriptors and typing"),
    ("sitator_tpu_torch.misc", "Misc transforms"),
    ("sitator_tpu_torch.visualization", "Plotting"),
    ("sitator_tpu_torch.util", "Utility substrate"),
    ("sitator_tpu_torch.parallel", "Frame sharding over cards"),
    ("sitator_tpu_torch.ops", "On-device ops (advanced)"),
    ("sitator_tpu_torch.compat", "Reference-namespace shim"),
]

OPS_MODULES = [
    "sitator_tpu_torch.ops.pbc", "sitator_tpu_torch.ops.landmark",
    "sitator_tpu_torch.ops.landmark_pallas",
    "sitator_tpu_torch.ops.landmark_mxu", "sitator_tpu_torch.ops.jumps",
    "sitator_tpu_torch.ops.cluster", "sitator_tpu_torch.ops.mcl",
    "sitator_tpu_torch.ops.msd", "sitator_tpu_torch.ops.correlation",
]

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "API_TORCH.md")


def _first_line(obj):
    doc = inspect.getdoc(obj)
    if not doc:
        return ""
    return doc.strip().splitlines()[0].rstrip()


def _signature(obj):
    try:
        sig = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return ""
    return sig if len(sig) <= 88 else sig[:85] + "...)"


def _entries(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for name in names:
        obj = getattr(mod, name, None)
        if obj is None or inspect.ismodule(obj):
            continue
        kind = ("class" if inspect.isclass(obj)
                else "func" if callable(obj) else "data")
        out.append((name, kind, _signature(obj) if kind != "data" else "",
                    _first_line(obj) if kind != "data" else ""))
    return out


def _section(lines, mod):
    for name, kind, sig, doc in _entries(mod):
        tag = "class " if kind == "class" else ""
        lines.append(f"- **`{tag}{name}{sig}`**"
                     + (f" — {doc}" if doc else ""))
    lines.append("")


def generate():
    lines = ["# sitator_tpu_torch API reference",
             "",
             "Generated by `sitator_tpu_torch/tools/gen_api_docs.py` from the "
             "port's live package surface — regenerate after any "
             "public-surface change (`tests/test_torch_api_docs.py` enforces "
             "freshness).  The reference's page is `docs/API.md`.",
             ""]
    for mod_name, title in MODULES:
        mod = importlib.import_module(mod_name)
        lines.append(f"## `{mod_name}` — {title}")
        head = _first_line(mod)
        lines.append(f"\n{head}\n" if head else "")
        _section(lines, mod)
        if mod_name == "sitator_tpu_torch.ops":
            for sub in OPS_MODULES:
                m = importlib.import_module(sub)
                lines.append(f"### `{sub}`")
                h = _first_line(m)
                lines.append(f"\n{h}\n" if h else "")
                _section(lines, m)
    return "\n".join(lines) + "\n"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    out_path = argv[0] if argv else OUT
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    text = generate()
    with open(out_path, "w") as f:
        f.write(text)
    print(f"wrote {out_path} ({text.count(chr(10))} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
