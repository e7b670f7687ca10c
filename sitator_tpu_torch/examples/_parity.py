"""When two runs of a walkthrough agree.

One rule holds the port's printed lines to the reference's (the parity
tests, ``tests/test_torch_examples_*.py``) and a card's run to the CPU's
(``chip_smoke.py::phase_examples``): both outputs have the same number of
lines, and each line that is not exempt, after every path under one of the
temporary roots is replaced by ``<path>``, has the same words, equal
integers, and floats within ``float_units`` units of their last printed
digit (0: the same digits).  :data:`EXEMPT` lists the lines that cannot
agree, by the comparison they are exempt from, each with its reason.

Where the card's streaming run labels a row otherwise than the CPU's (K1's
bf16 similarities against the dense route's f32), :func:`gate_margins`
gives the rows' f32 top-2 margins, which ``tools/bench.py::gated`` holds to
the precision gate.
"""
import re

import numpy as np

# the two comparisons: the reference's walkthrough against the port's on
# the CPU, and the port's on a card against its own on the CPU
REFERENCE, CARD = "reference", "card"

# example -> [(pattern of the exempt line, why it cannot agree, the
# comparisons it is exempt from)]
EXEMPT = {
    "landmark_walkthrough": [
        (r"^\s+(voronoi seeding|landmark analysis|merging \+ filters|"
         r"jump analysis|TOTAL)\s+[\d.]+s",
         "timings of the StageTimer report", (REFERENCE, CARD)),
    ],
    "diffusion_kinetics": [
        (r"^KMC closure:",
         "the walk's random stream differs: jax.random in the reference, "
         "the seeded torch.Generator of the card or of the CPU in the port; "
         "each run holds closure < 0.02 by the example's assert",
         (REFERENCE, CARD)),
    ],
    "multichip_mesh": [
        (r"^On a v5e-8 the identical code|^On a host with several cards",
         "device names: the reference names its TPU slice, the port cards",
         (REFERENCE,)),
        (r"^frame_mesh\(\) picks up the real chips|^it picks up every "
         r"visible card",
         "device names: the reference names its TPU interconnect",
         (REFERENCE,)),
        (r"^devices: ", "device names: cuda on the card, cpu on the host",
         (CARD,)),
    ],
}

# a card's float may differ from the CPU's by one unit in its last printed
# digit: the card sums f32 products in other orders (K2's landmark
# vectors, the device reductions of the clustering and the scattering
# phases), which can carry a printed value across a rounding boundary
CARD_FLOAT_UNITS = 1

NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def exempt_lines(name, against):
    """The compiled patterns of ``name``'s lines exempt from ``against``
    (:data:`REFERENCE` or :data:`CARD`); ``name`` with or without
    ``.py``."""
    return [re.compile(p) for p, _, sides in
            EXEMPT.get(name.removesuffix(".py"), ()) if against in sides]


def mask_paths(line, roots):
    """``line`` with each path under one of ``roots`` replaced by
    ``<path>``."""
    alt = "|".join(re.escape(r.rstrip("/"))
                   for r in sorted(set(roots), key=len, reverse=True))
    return re.sub(rf"(?:{alt})/[^\s,;:)]*", "<path>", line)


def last_digit_unit(token):
    """One unit in the last printed digit of the number ``token``."""
    mant, _, exp = token.lower().partition("e")
    return 10.0 ** (int(exp or 0) - len(mant.partition(".")[2]))


def differences(name, a_out, b_out, roots, against=REFERENCE,
                float_units=0):
    """The lines on which outputs ``a_out`` and ``b_out`` of example
    ``name`` differ, by the rule of this module; empty when they agree."""
    a_lines = a_out.rstrip("\n").split("\n")
    b_lines = b_out.rstrip("\n").split("\n")
    if len(a_lines) != len(b_lines):
        return [f"{len(a_lines)} lines against {len(b_lines)}"]
    exempt = exempt_lines(name, against)
    bad = []
    for k, (a, b) in enumerate(zip(a_lines, b_lines)):
        if any(e.search(a) or e.search(b) for e in exempt):
            continue
        a, b = mask_paths(a, roots), mask_paths(b, roots)
        both = f":\n  {a}\n  {b}"
        if NUMBER.sub("#", a) != NUMBER.sub("#", b):
            bad.append(f"line {k}: words differ{both}")
            continue
        for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
            if x == y:
                continue
            if not any(c in x + y for c in ".eE"):
                if int(x) != int(y):
                    bad.append(f"line {k}: numbers differ (integer {x} / "
                               f"{y}){both}")
            elif float_units == 0 or abs(float(x) - float(y)) > (
                    float_units * max(last_digit_unit(x), last_digit_unit(y))
                    * (1 + 1e-9)):
                bad.append(f"line {k}: numbers differ (float {x} / {y})"
                           f"{both}")
    return bad


def gate_margins(md, seeds, centers, rows, device, *, cutoff_midpoint,
                 cutoff_steepness, **_):
    """The f32 top-2 margins and top-1 similarities of the (frame, ion)
    ``rows`` of ``md``'s trajectory, from the dense route's landmark
    vectors against the unit ``centers`` on ``device``: NumPy ``(len(rows),)``
    each, for ``tools/bench.py::gated``.  The cutoff is the streaming
    engine's (``**_`` takes the rest of its settings)."""
    import torch
    from sitator_tpu_torch.ops import landmark as lmops
    from sitator_tpu_torch.tools.bench import margin_top1
    rows = np.asarray(rows)
    verts, vmask = seeds.padded_vertices()
    si, mi = np.flatnonzero(md.static_mask), np.flatnonzero(md.mobile_mask)
    cell = torch.as_tensor(md.structure.cell, dtype=torch.float32,
                           device=device)
    frames = torch.as_tensor(md.traj[rows[:, 0]], dtype=torch.float32,
                             device=device)
    lv = lmops.landmark_vectors(
        frames[:, mi], frames[:, si],
        lmops.vertex_membership_matrix(verts, vmask, len(si)).to(device),
        cell, torch.linalg.inv(cell), cutoff_midpoint, cutoff_steepness)
    margin, top1 = margin_top1(
        lmops.normalize_landmark_vectors(lv)[0],
        torch.as_tensor(np.asarray(centers), dtype=torch.float32,
                        device=device))
    pick = np.arange(len(rows))
    return margin[pick, rows[:, 1]], top1[pick, rows[:, 1]]
