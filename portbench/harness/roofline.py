"""The least time the card could take for the assignment's work, from a
configuration's sizes alone: not from the route that serves it, its tiles
or its padding, so that the share reads the same work whatever implements
it.

Operations, a frame:

- the similarity product, ``2 M S K`` in the similarity operand type (bf16
  on the tensor cores);
- the landmark-vector core in float32: 25 for each (ion, vertex atom)
  pair (3 subtractions; 12 for the minimum image: scale, round, rescale,
  subtract on each axis; 5 for d²; 5 for the cutoff: shift, scale, exp,
  add, log) and ``V + 2`` for each (ion, site) pair (``V - 1`` additions
  of the vertices' logs, one exp, a multiply and an add for the norm).

Bytes, a frame: every atom's position read once (float32); labels (int32)
and confidences (float32) written once; once an engine block, the vertex
lists (int32) and the float32 centres read once.

The tensor cores and the float32 pipes run at once, and the memory too, so
the bound is the largest of the three times, not their sum."""

# published dense peaks of the SXM part at its 700 W limit (NVIDIA's data
# sheet): operations/s by operand type, and device memory bytes/s
PEAKS = {
    "H100": {"bfloat16": 989e12, "float32": 67e12, "bytes": 3.35e12},
}


def peaks(device_name):
    """The peaks of the card named ``device_name``, or None for a card the
    table does not hold."""
    for key, p in PEAKS.items():
        if key in (device_name or ""):
            return p
    return None


def assign_work(cfg, n_frames):
    """``{term: (amount, unit)}`` of the assignment of ``n_frames`` frames:
    operations by type and bytes."""
    M, S, K = int(cfg["n_ions"]), int(cfg["n_sites"]), int(cfg["n_centres"])
    V, N = int(cfg["vertices_per_site"]), int(cfg["n_static"])
    F = int(n_frames)
    blocks = -(-F // int(cfg["block_frames"]))
    op = cfg["precision"]["similarity_operands"]
    return {
        "product": (2 * M * S * K * F, op),
        "core": (F * M * (25 * N + (V + 2) * S), "float32"),
        "bytes": (F * ((N + M) * 3 * 4 + M * (4 + 4))
                  + blocks * (S * V * 4 + K * S * 4), "bytes"),
    }


def assign_bound(cfg, n_frames, pk):
    """``(seconds, which term binds, {term: seconds})`` at the peaks
    ``pk``."""
    times = {}
    for term, (amount, unit) in assign_work(cfg, n_frames).items():
        times[term] = amount / pk[unit]
    which = max(times, key=times.get)
    return times[which], which, times
