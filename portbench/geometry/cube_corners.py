"""A simple-cubic host of ``n_cells``^3 static atoms at spacing
``a_lattice``, one site at the centre of every cube whose 8 corner atoms are
its vertices: each static atom is a vertex of 8 sites (the unique-atom K1
route).  The arrays of ``sitator_tpu_torch/tools/bench_config.py``, vertex
for vertex; ``grid`` holds each site's integer cube index."""
import numpy as np


def build(cfg):
    n, a = int(cfg["n_cells"]), float(cfg["a_lattice"])
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                       axis=-1).reshape(-1, 3)
    verts = np.stack([(((grid + d) % n) * [n * n, n, 1]).sum(1)
                      for d in corners], axis=1).astype(np.int32)
    return dict(cell=np.eye(3) * a * n, static=grid * a,
                sites=(grid + 0.5) * a, verts=verts, grid=grid)
