"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: the
one-thread warm-up of torch's math functions, and functions that make the
same ``Structure`` / ``SiteNetwork`` / ``SiteTrajectory`` in both packages
from one set of NumPy arrays."""
import numpy as np
import torch

import sitator_tpu as ref
import sitator_tpu_torch as port


def first_math_calls_on_one_thread():
    """Call each vectorised math function the port reaches once, on a
    tensor below torch's parallel grain.  With JAX loaded in the same
    process, the first call of such a function on an MKL-built CPU torch
    has been seen to return 12-bit approximations on the chunks of some of
    the threads that ran it at once; later calls are exact.  A test file
    calls this at import, so no first call is a parallel one."""
    x = torch.linspace(0.5, 2.0, 1024)
    for fn in (torch.sqrt, torch.rsqrt, torch.exp, torch.log, torch.log1p,
               torch.cos, torch.sin, torch.round, torch.abs, torch.floor):
        fn(x)
    torch.atan2(x, x)
    torch.pow(x, torch.arange(1024) % 7)
    x[:64].reshape(8, 8) @ x[:64].reshape(8, 8)


def networks(positions, species, cell, static_mask, mobile_mask,
             centers=None, vertices=None, site_types=None):
    """(reference SiteNetwork, port SiteNetwork) from the same arrays."""
    out = []
    for pkg in (ref, port):
        s = pkg.Structure(np.array(positions, np.float64),
                          np.array(species), np.array(cell, np.float64))
        sn = pkg.SiteNetwork(s, np.array(static_mask), np.array(mobile_mask))
        if centers is not None:
            sn.centers = np.array(centers, np.float64)
        if vertices is not None:
            sn.vertices = [np.array(v) for v in vertices]
        if site_types is not None:
            sn.site_types = np.array(site_types)
        out.append(sn)
    return tuple(out)


def networks_of(md, **kw):
    """Both packages' networks of a ``SyntheticMD`` (either package's)."""
    s = md.structure
    return networks(s.positions, s.species, s.cell, md.static_mask,
                    md.mobile_mask, **kw)


def trajectories(sns, traj, real_traj=None, confidences=None):
    """(reference SiteTrajectory, port SiteTrajectory) over ``sns`` (the
    pair from :func:`networks`) with the same labels and real frames."""
    out = []
    for pkg, sn in zip((ref, port), sns):
        st = pkg.SiteTrajectory(sn, np.array(traj, np.int32),
                                None if confidences is None
                                else np.array(confidences))
        if real_traj is not None:
            st.set_real_traj(np.array(real_traj))
        out.append(st)
    return tuple(out)


def assert_same_results(want, got, rtol=1e-12, where="result"):
    """Recursively hold ``got`` (the port's) to ``want`` (the reference's):
    arrays and numbers to ``rtol`` (NaN where NaN), dicts by key, lists and
    tuples by item, networks by centres and attributes, trajectories by
    labels and network; an engine by its fitted attributes (names ending
    in ``_``)."""
    if isinstance(want, (ref.SiteTrajectory, port.SiteTrajectory)):
        np.testing.assert_array_equal(got.traj, want.traj, err_msg=where)
        assert_same_results(want.site_network, got.site_network, rtol,
                            where + ".site_network")
    elif isinstance(want, (ref.SiteNetwork, port.SiteNetwork)):
        assert got.n_sites == want.n_sites, where
        if want.centers is not None:
            np.testing.assert_allclose(got.centers, want.centers, rtol=rtol,
                                       err_msg=where)
        for kind in ("site", "edge"):
            names = getattr(want, kind + "_attributes")
            assert sorted(getattr(got, kind + "_attributes")) == \
                sorted(names), (where, kind)
            for k in names:
                get = "get_%s_attribute" % kind
                assert_same_results(getattr(want, get)(k),
                                    getattr(got, get)(k), rtol,
                                    f"{where}.{k}")
    elif isinstance(want, dict):
        assert sorted(map(repr, got)) == sorted(map(repr, want)), where
        for k in want:
            assert_same_results(want[k], got[k], rtol, f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same_results(w, g, rtol, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic, float, int)) and \
            not isinstance(want, bool):
        w, g = np.asarray(want), np.asarray(got)
        assert g.shape == w.shape, (where, g.shape, w.shape)
        if w.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                       equal_nan=True, err_msg=where)
        else:
            np.testing.assert_array_equal(g, w, err_msg=where)
    elif hasattr(want, "__dict__") and not callable(want):
        fitted = sorted(k for k in vars(want)
                        if k.endswith("_") and not k.startswith("_"))
        assert fitted == sorted(k for k in vars(got) if k.endswith("_")
                                and not k.startswith("_")), where
        for k in fitted:
            assert_same_results(getattr(want, k), getattr(got, k), rtol,
                                f"{where}.{k}")
    else:
        assert got == want, (where, got, want)
