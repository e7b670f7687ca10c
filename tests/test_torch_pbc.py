"""The functional PBC ops of the port (``ops.pbc``) against the JAX
package's on the same seeded points, float32 on both sides: ``atol=2e-5``
(the same formulas; products and sums may associate differently).
``rescale_to_cell`` is float64 NumPy in both: ``atol=1e-12``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sitator_tpu.ops import pbc as rp
from sitator_tpu_torch.ops import pbc as pp

torch.set_num_threads(2)

CELLS = {
    "cubic": np.eye(3) * 10.0,
    "ortho": np.diag([8.0, 11.0, 9.5]),
    "triclinic": np.array([[9.0, 0, 0], [1.5, 8.0, 0], [0.5, 1.0, 10.0]]),
}
ATOL = 2e-5


def _setup(name, seed, n=40, spread=2.5):
    rng = np.random.default_rng(seed)
    cell = CELLS[name].astype(np.float32)
    pts = ((rng.random((n, 3)) * spread - 0.7) @ cell).astype(np.float32)
    ci = np.linalg.inv(cell).astype(np.float32)
    return (pts, (jnp.asarray(cell), jnp.asarray(ci)),
            (torch.from_numpy(cell), torch.from_numpy(ci)))


@pytest.mark.parametrize("name", list(CELLS))
def test_wrap_and_cell_inverse(name):
    pts, jc, tc = _setup(name, 0)
    np.testing.assert_allclose(pp.cell_inverse(tc[0]).numpy(),
                               np.asarray(rp.cell_inverse(jc[0])), atol=1e-6)
    got = pp.wrap(torch.from_numpy(pts), *tc).numpy()
    np.testing.assert_allclose(got, np.asarray(rp.wrap(jnp.asarray(pts), *jc)),
                               atol=ATOL)
    frac = got @ np.linalg.inv(CELLS[name])
    assert (frac > -1e-5).all() and (frac < 1 + 1e-5).all()
    f = torch.from_numpy(pts[:, 0])
    np.testing.assert_array_equal(
        pp.wrap_frac(f).numpy(),
        np.asarray(rp.wrap_frac(jnp.asarray(pts[:, 0]))))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name", list(CELLS))
def test_distances(name, exact):
    pts, jc, tc = _setup(name, 1)
    a, b = pts[:25], pts[25:]
    got = pp.pairwise_pbc_distances(torch.from_numpy(a), torch.from_numpy(b),
                                    *tc, exact=exact).numpy()
    want = np.asarray(rp.pairwise_pbc_distances(jnp.asarray(a),
                                                jnp.asarray(b), *jc,
                                                exact=exact))
    assert got.shape == (25, 15)
    np.testing.assert_allclose(got, want, atol=ATOL)
    got1 = pp.pbc_distance(torch.from_numpy(a[:15]), torch.from_numpy(b),
                           *tc, exact=exact).numpy()
    np.testing.assert_allclose(
        got1, np.asarray(rp.pbc_distance(jnp.asarray(a[:15]),
                                         jnp.asarray(b), *jc, exact=exact)),
        atol=ATOL)
    np.testing.assert_allclose(got1, np.diagonal(got[:15]), atol=ATOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(CELLS))
def test_averages(name, weighted):
    """A cloud scattered around a point near a cell face, spread over its
    periodic images."""
    rng = np.random.default_rng(2)
    cell = CELLS[name].astype(np.float32)
    _, jc, tc = _setup(name, 2)
    centre = np.array([0.02, 0.5, 0.97]) @ cell
    pts = centre + rng.normal(scale=0.2, size=(30, 3))
    pts = (pts + rng.integers(-1, 2, size=(30, 3)) @ cell).astype(np.float32)
    w = rng.random(30).astype(np.float32) if weighted else None
    got = pp.pbc_average(torch.from_numpy(pts), *tc, weights=w).numpy()
    want = np.asarray(rp.pbc_average(jnp.asarray(pts), *jc, weights=w))
    np.testing.assert_allclose(got, want, atol=ATOL)
    ref_pt = pts[3]
    np.testing.assert_allclose(
        pp.pbc_average(torch.from_numpy(pts), *tc, weights=w,
                       ref=torch.from_numpy(ref_pt)).numpy(),
        np.asarray(rp.pbc_average(jnp.asarray(pts), *jc, weights=w,
                                  ref=jnp.asarray(ref_pt))), atol=ATOL)
    mask = rng.random(30) < 0.6
    gm = pp.masked_pbc_average(torch.from_numpy(pts), torch.from_numpy(mask),
                               *tc, weights=w).numpy()
    wm = np.asarray(rp.masked_pbc_average(jnp.asarray(pts),
                                          jnp.asarray(mask), *jc, weights=w))
    np.testing.assert_allclose(gm, wm, atol=ATOL)
    # the masked mean is the mean of the selected members
    sub = pp.pbc_average(torch.from_numpy(pts[mask]), *tc,
                         weights=None if w is None else w[mask]).numpy()
    d = pp.pbc_distance(torch.from_numpy(gm), torch.from_numpy(sub), *tc)
    assert float(d) < 1e-4


@pytest.mark.parametrize("case", ["frames", "single_cell", "one_frame",
                                  "origins"])
def test_rescale_to_cell(case):
    rng = np.random.default_rng(3)
    F, A = 5, 7
    ref_cell = CELLS["triclinic"]
    cells = ref_cell[None] * (1 + 0.02 * rng.normal(size=(F, 1, 1)))
    pos = rng.uniform(-3, 12, size=(F, A, 3))
    kw = {}
    if case == "single_cell":
        cells = cells[0]
    if case == "one_frame":
        pos, cells = pos[0], cells[0]
    if case == "origins":
        kw = dict(origins=rng.normal(size=(F, 3)),
                  ref_origin=np.array([0.5, -0.2, 0.1]))
    got = pp.rescale_to_cell(pos, cells, ref_cell, **kw)
    want = rp.rescale_to_cell(pos, cells, ref_cell, **kw)
    assert got.shape == pos.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-12)
