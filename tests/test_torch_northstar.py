"""The north-star tool of the port (``sitator_tpu_torch.tools``:
``bench_config``, ``northstar_run``) and the engines' frames already on a
device, on the CPU at small sizes.

- ``bench_config.build_system`` equals the reference's ``bench.build_system``
  array for array;
- ``CycleReader`` against an index oracle, NumPy and tensor pools alike;
- the tool's path at the ``--small`` size (a pool of 2 blocks of 64 frames
  cycled over 5 blocks) through the JAX package's streaming engine and the
  port's: fitted centres within 1e-5 (f32 landmark vectors summed in another
  order), labels equal wherever the reference's f32 top-2 margin exceeds
  1e-5 and the best similarity is not within 1e-5 of the threshold, jump
  statistics and occupancies equal;
- the engines fed tensors whose ``__array__`` raises (as a CUDA tensor's
  does) give exactly the result of NumPy frames, with no block staged
  through host memory;
- the host int64 recount against the reference's scan, and the tool end
  to end with its checks, which fail on an altered label.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
import sitator_tpu as ref
from sitator_tpu.landmark import StreamingLandmarkAnalysis as JaxStreaming
from sitator_tpu.ops import landmark as jlm

import sitator_tpu_torch as port
from sitator_tpu_torch.ops.jumps import _jump_stats_block_int64
from sitator_tpu_torch.tools import bench_config
from sitator_tpu_torch.tools import northstar_run as ns

from tests._torch_common import first_math_calls_on_one_thread
from tests.test_torch_streaming import _assert_same_result

torch.set_num_threads(2)

first_math_calls_on_one_thread()

SMALL = ns.SMALL
B_SMALL = SMALL["block_frames"]


def _closure(fn):
    """The variables a nested function closes over, by name."""
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


# -- bench_config ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_bench_config_equals_bench(seed):
    want = bench.build_system(seed)
    got = bench_config.build_system(seed)
    assert (bench_config.N_CELLS, bench_config.A_LAT, bench_config.N_IONS,
            bench_config.K_CENTERS) == (bench.N_CELLS, bench.A_LAT,
                                        bench.N_IONS, bench.K_CENTERS)
    for name, a, b in (("cell", got.cell, want[0]),
                       ("verts", got.verts, want[1]),
                       ("centers", got.centers, want[3])):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.n_static == want[4]
    np.testing.assert_array_equal(got.occ, _closure(want[2])["occ"])
    for s in (3, 11):
        for a, b in zip(got.frames(8, s), want[2](8, s)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


# -- CycleReader -------------------------------------------------------------

def _pool(n_blocks=3, block=5, atoms=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(block, atoms, 3)).astype(np.float32)
            for _ in range(n_blocks)]


@pytest.mark.parametrize("lo,hi", [
    (2, 4),        # inside a block, starting mid-block
    (3, 9),        # across one block border
    (0, 15),       # the whole pool
    (12, 33),      # wraps the pool (3 blocks of 5)
    (7, None),     # to the end, which stops short of a block
    (31, 40),      # past the end: clipped
    (-6, None),    # counted from the end
    (9, 9),        # empty
])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_cycle_reader_slices(lo, hi, kind):
    pool = _pool()
    n = 33
    want_idx = range(*slice(lo, hi).indices(n))
    want = np.stack([pool[(f // 5) % 3][f % 5] for f in want_idx]) \
        if len(want_idx) else np.zeros((0, 4, 3), np.float32)
    blocks = pool if kind == "numpy" else [torch.as_tensor(b) for b in pool]
    reader = ns.CycleReader(blocks, n)
    got = reader[lo:hi]
    assert len(reader) == n and reader.n_atoms == 4
    assert torch.is_tensor(got) == (kind == "tensor")
    np.testing.assert_array_equal(np.asarray(got), want)


def test_cycle_reader_rejects():
    pool = _pool()
    with pytest.raises(ValueError):
        ns.CycleReader(pool + [pool[0][:2]], 10)
    reader = ns.CycleReader(pool, 10)
    with pytest.raises(TypeError):
        reader[3]
    with pytest.raises(ValueError):
        reader[0:10:2]


# -- the tool's path against the reference ---------------------------------

def _small_system():
    """The ``--small`` bench system, a NumPy pool of 2 x 64 frames made from
    a seed with its statistics, and both packages' SiteNetworks."""
    sn, sy = ns.bench_network(small=True)
    rng = np.random.default_rng(7)
    pool = []
    for _ in range(SMALL["pool_blocks"]):
        st = sy.host + rng.normal(scale=0.05,
                                  size=(B_SMALL,) + sy.host.shape)
        mo = sy.sites[sy.occ] + rng.normal(scale=0.25,
                                           size=(B_SMALL, len(sy.occ), 3))
        pool.append(np.concatenate([st, mo], 1).astype(np.float32))
    s = sn.structure
    rsn = ref.SiteNetwork(ref.Structure(s.positions, s.species, s.cell),
                          sn.static_mask, sn.mobile_mask)
    rsn.centers = sy.sites
    rsn.vertices = [sy.verts[i] for i in range(sy.n_static)]
    return sn, rsn, sy, pool


class JaxCycleReader:
    """The reference tool's reader: resident ``jnp`` blocks, cycled."""

    def __init__(self, blocks, n_frames):
        self.blocks = [jnp.asarray(b) for b in blocks]
        self.n = n_frames

    def __len__(self):
        return self.n

    def __getitem__(self, key):
        lo, hi = key.start or 0, min(self.n if key.stop is None
                                     else key.stop, self.n)
        B = self.blocks[0].shape[0]
        parts = []
        while lo < hi:
            off, take = lo % B, min(B - lo % B, hi - lo)
            parts.append(self.blocks[(lo // B) % len(self.blocks)]
                         [off:off + take])
            lo += take
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


def _f32_gate(sn, frames, centers, thr=0.35):
    """True where the reference's f32 top-2 margin is within 1e-5 or the
    best similarity within 1e-5 of the threshold."""
    mob = frames[:, sn.mobile_mask]
    sta = frames[:, sn.static_mask]
    verts, vmask = sn.padded_vertices()
    cell = np.asarray(sn.structure.cell, np.float32)
    lv = jlm.landmark_vectors(
        jnp.asarray(mob), jnp.asarray(sta),
        jlm.vertex_membership_matrix(verts, vmask, sta.shape[1]),
        jnp.asarray(cell), jnp.asarray(np.linalg.inv(cell), jnp.float32),
        4.0, 3.0, cutoff_shape="logistic_r2")
    sims = np.asarray(jlm.normalize_landmark_vectors(lv)[0]) @ centers.T
    top = -np.sort(-sims, axis=-1)[..., :2]
    return (top[..., 0] - top[..., 1] <= 1e-5) | (np.abs(top[..., 0] - thr)
                                                   <= 1e-5)


def test_small_northstar_path_matches_reference(tmp_path):
    """Fit on one cycled block and pass 2 over 5 blocks of a pool of 2 (the
    pool wraps twice): the reference's engine on ``jnp`` blocks against the
    port's on CPU tensors."""
    sn, rsn, sy, pool = _small_system()
    n = 5 * B_SMALL
    kw = dict(ns.KW, block_frames=B_SMALL, verbose=False)
    want_fit = JaxStreaming(clustering_params={"k_max": 1024}, **kw) \
        .fit_centers(rsn, JaxCycleReader(pool, B_SMALL))
    tpool = [torch.as_tensor(b) for b in pool]
    got_fit = ns.fit_centers(sn, tpool, sy.centers, str(tmp_path), "cpu",
                             cache=False)
    K = len(sy.centers)
    assert got_fit.shape == (K, sy.n_static) and len(want_fit) < K
    np.testing.assert_allclose(got_fit[:len(want_fit)], want_fit, atol=1e-5)
    np.testing.assert_array_equal(got_fit[len(want_fit):],
                                  sy.centers[:K - len(want_fit)])

    centers = got_fit
    want_eng = JaxStreaming(store_labels=str(tmp_path / "j.npy"), **kw)
    want = want_eng.run(rsn, JaxCycleReader(pool, n), centers=centers)
    eng = ns.make_engine(str(tmp_path), "t", block_frames=B_SMALL,
                         device="cpu")
    got = eng.run(sn, ns.CycleReader(tpool, n), centers=centers)
    lt = np.load(tmp_path / "ns_labels_t.npy")
    lj = np.load(tmp_path / "j.npy")
    frames = np.concatenate([pool[(b % 2)] for b in range(5)])
    gate = _f32_gate(sn, frames, centers)
    assert (~gate).all()
    np.testing.assert_array_equal(lt, lj)
    _assert_same_result(got, want)
    assert eng.staged_blocks_ == 0


# -- frames already on a device: the engines never ask for a host array ------

class NoHost(torch.Tensor):
    """A tensor that, like a CUDA tensor, cannot become a NumPy array
    through ``__array__``; what is computed from it stays a ``NoHost``."""

    def __array__(self, *args, **kwargs):
        raise RuntimeError("NoHost: no implicit host copy")


def _no_host(a):
    return torch.as_tensor(a).as_subclass(NoHost)


@pytest.fixture(scope="module")
def small():
    sn, _, sy, pool = _small_system()
    centers = ns.fit_centers(sn, [torch.as_tensor(b) for b in pool],
                             sy.centers, None, "cpu", cache=False)
    return sn, sy, pool, centers


def test_no_host_tensor_raises_on_array():
    with pytest.raises(RuntimeError, match="NoHost"):
        np.asarray(_no_host(np.zeros(3))[1:])


def test_fit_centers_takes_device_frames(small):
    sn, sy, pool, _ = small
    kw = dict(ns.KW, block_frames=B_SMALL, verbose=False, device="cpu",
              clustering_params={"k_max": 1024})
    reader = ns.CycleReader([_no_host(b) for b in pool], 3 * B_SMALL)
    got = port.StreamingLandmarkAnalysis(**kw).fit_centers(sn, reader)
    want = port.StreamingLandmarkAnalysis(**kw).fit_centers(
        sn, ns.CycleReader(pool, 3 * B_SMALL))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth,shards", [(2, None), (0, None), (2, 2),
                                          (0, 2)])
def test_run_takes_device_frames(small, tmp_path, depth, shards):
    sn, sy, pool, centers = small
    mesh = None if shards is None else port.parallel.frame_mesh(
        devices=["cpu"] * shards)
    n = 5 * B_SMALL - 3          # the last block is short

    def run(blocks, tag):
        eng = ns.make_engine(str(tmp_path), tag, block_frames=B_SMALL,
                             device="cpu", pipeline_depth=depth, mesh=mesh)
        out = eng.run(sn, ns.CycleReader(blocks, n), centers=centers)
        return eng, out, np.load(eng.store_labels)

    e_t, got, lab_t = run([_no_host(b) for b in pool], "tensor")
    e_n, want, lab_n = run(pool, "numpy")
    np.testing.assert_array_equal(lab_t, lab_n)
    _assert_same_result(got, want, centre_atol=0)
    for k, v in e_n.final_state_.items():
        np.testing.assert_array_equal(e_t.final_state_[k], v, err_msg=k)
    assert e_t.staged_blocks_ == 0
    assert e_n.staged_blocks_ == (5 if depth else 0)


@pytest.mark.parametrize("shards", [None, 2])
def test_pipeline_run_block_takes_device_frames(small, shards):
    sn, sy, pool, centers = small
    mesh = port.parallel.frame_mesh(devices=["cpu"] * (shards or 1))
    pipe = port.SpmdLandmarkPipeline(
        sn, centers, np.ones(len(centers), bool), mesh=mesh, device="cpu",
        cutoff_midpoint=4.0, cutoff_steepness=3.0,
        cutoff_shape="logistic_r2")
    frames = pool[0][:B_SMALL - 1]       # odd: padded on a 2-shard mesh
    got = pipe.run_block(_no_host(frames))
    want = pipe.run_block(frames)
    got2 = pipe.run_block(_no_host(pool[1]),
                          carry=(got[2]["last_sites"], got[2]["last_res"]))
    want2 = pipe.run_block(pool[1], carry=(want[2]["last_sites"],
                                           want[2]["last_res"]))
    for g, w in ((got, want), (got2, want2)):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        for k in w[2]:
            np.testing.assert_array_equal(g[2][k], w[2][k], err_msg=k)


def test_landmark_analysis_takes_device_frames(small):
    sn, sy, pool, _ = small
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
              cutoff_shape="logistic_r2", verbose=False, device="cpu")
    frames = np.concatenate(pool)[:40]
    got = port.LandmarkAnalysis(**kw).run(sn, _no_host(frames))
    want = port.LandmarkAnalysis(**kw).run(sn, frames)
    np.testing.assert_array_equal(got.traj, want.traj)
    np.testing.assert_array_equal(got.site_network.centers,
                                  want.site_network.centers)
    np.testing.assert_array_equal(got.real_trajectory, frames)


def test_pad_and_place_frames_take_tensors():
    from sitator_tpu_torch.parallel.mesh import (pad_frames, place_frames,
                                                 take_columns)
    a = np.arange(5 * 4 * 3, dtype=np.float64).reshape(5, 4, 3)
    for arr in (a, torch.as_tensor(a)):
        padded, n = pad_frames(arr, 4)
        assert n == 5 and torch.is_tensor(padded) == torch.is_tensor(arr)
        np.testing.assert_array_equal(np.asarray(padded),
                                      np.concatenate([a, a[-1:].repeat(3,
                                                                        0)]))
        cache = {}
        cols = take_columns(arr, np.array([3, 1]), cache)
        np.testing.assert_array_equal(np.asarray(cols), a[:, [3, 1]])
        placed = place_frames(cols, None, "cpu")
        assert placed.dtype == torch.float32
        np.testing.assert_array_equal(placed.numpy(),
                                      a[:, [3, 1]].astype(np.float32))
    assert len(cache) == 1


# -- the host recount and the tool -------------------------------------------

def _labels_with_gaps(seed, n_frames, n_ions, K):
    rng = np.random.default_rng(seed)
    stay = rng.integers(0, K, size=n_ions)
    labels = np.empty((n_frames, n_ions), np.int32)
    for f in range(n_frames):
        hop = rng.random(n_ions) < 0.15
        stay = np.where(hop, rng.integers(0, K, size=n_ions), stay)
        labels[f] = stay
    labels[rng.random(labels.shape) < 0.1] = -1
    labels[:7, 0] = -1                  # a leading gap
    labels[:, 1] = -1                   # never assigned
    return labels


@pytest.mark.parametrize("chunk", [1, 3, 16, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_recount_matches_int64_oracle(seed, chunk):
    K, M = 6, 9
    labels = _labels_with_gaps(seed, 57, M, K)
    got = ns.recount(labels, K, chunk=chunk)
    st, last, res = _jump_stats_block_int64(
        labels, K, np.full(M, -1, np.int64), np.zeros(M, np.int64),
        "persist")
    for k in ("n_ij", "lag_sum", "res_sum", "res_cnt"):
        np.testing.assert_array_equal(got[k], st[k], err_msg=k)
    np.testing.assert_array_equal(got["occ"][:K], st["occ_counts"])
    assert got["occ"][K] == (labels < 0).sum()
    np.testing.assert_array_equal(got["carry_last"], last)
    np.testing.assert_array_equal(got["carry_res"], res)
    assert got["n_ij"].sum() > 0


def test_checks_hold_and_fail_on_an_altered_label(small, tmp_path):
    sn, sy, pool, centers = small
    n = 5 * B_SMALL
    eng = ns.make_engine(str(tmp_path), "c", block_frames=B_SMALL,
                         device="cpu")
    out = eng.run(sn, ns.CycleReader([torch.as_tensor(b) for b in pool], n),
                  centers=centers)
    period = 2 * B_SMALL
    labels = np.load(eng.store_labels, mmap_mode="r+")
    assert ns.check_periodic(labels, period) == n - period
    assert ns.check_recount(labels, eng, out)["assigned"] > 0
    f = period + 3
    labels[f, 0] = (labels[f, 0] + 1) % len(centers)
    labels.flush()
    with pytest.raises(ns.CheckFailed, match=r"\(a\).*frame 131"):
        ns.check_periodic(labels, period)
    with pytest.raises(ns.CheckFailed, match=r"\(b\)"):
        ns.check_recount(labels, eng, out)


def test_check_memory():
    host = dict(RssAnon=1000, VmData=5000, VmRSS=9000)
    grown = dict(RssAnon=1050, VmData=5000, VmRSS=90000)   # memmap pages
    assert ns.check_memory((100, host), (105, grown)) == "RssAnon"
    with pytest.raises(ns.CheckFailed, match="peak device"):
        ns.check_memory((100, host), (106, host))
    with pytest.raises(ns.CheckFailed, match="RssAnon"):
        ns.check_memory((None, host), (None, dict(host, RssAnon=1051)))
    # a kernel without RssAnon: VmData is checked, VmRSS never
    no_anon = dict(VmData=5000, VmRSS=9000)
    assert ns.check_memory((None, no_anon),
                           (None, dict(no_anon, VmRSS=90000))) == "VmData"
    with pytest.raises(ns.CheckFailed, match="VmData"):
        ns.check_memory((None, no_anon), (None, dict(no_anon, VmData=5251)))
    assert set(ns.host_memory()) == set(ns.HOST_KEYS)


@pytest.mark.parametrize("extra", [[], ["--split"]])
def test_northstar_small_on_cpu(tmp_path, capsys, extra):
    rc = ns.main(["--small", "--device", "cpu", "--blocks", "5",
                  "--workdir", str(tmp_path)] + extra)
    assert rc == 0
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")][-1]
    res = json.loads(line)
    assert res == json.loads((tmp_path / "northstar_result.json")
                             .read_text())
    assert res["n_frames"] == 5 * B_SMALL and res["value"] > 0
    assert res["check_recount"] == "held"
    assert res["check_periodic_frames"] == 3 * B_SMALL
    assert res["staged_blocks"] == 0 and res["device"] == "cpu"
    assert "v5e8_projection_s_1M_frames" not in res
    for k in ("wall_s", "phase_times", "host_link_dl_MBps",
              "host_link_ul_pinned_MBps", "host_GB_end"):
        assert k in res, k
    if extra:
        for k in ("split_math_fps", "split_engine_loop_fps",
                  "split_host_overhead_share", "split_phase_share_of_loop"):
            assert k in res, k
        assert [t for t, _ in res["split_segments"]] == ["math",
                                                         "engine"] * 3
    assert not os.path.exists(tmp_path / "ns_ckpt_main.npz")


def test_northstar_ab_modes_on_cpu(tmp_path):
    """Every same-process A/B runs its variants and reports their medians."""
    rc = ns.main(["--small", "--device", "cpu", "--blocks", "2", "--no-labels",
                  "--workdir", str(tmp_path), "--ab", "--ab-pipeline",
                  "--ab-depth"])
    assert rc == 0
    res = json.loads((tmp_path / "northstar_result.json").read_text())
    for k in ("ab_sync_labels_fps", "ab_no_labels_fps",
              "ab_pipeline_sync_fps", "ab_pipeline_piped_fps",
              "ab_pipeline_ratio", "ab_depth_d2_fps", "ab_depth_d4_fps"):
        assert res[k] > 0, k
    assert [t for t, _ in res["ab_depth_segments"]] == ["d2", "d4"] * 2
    assert "ab_async_labels_fps" not in res
    assert "check_recount" not in res      # no labels: (a) and (b) skipped


def test_northstar_exit_codes(tmp_path, monkeypatch, capsys):
    assert ns.main(["--small", "--ab-pack", "--device", "cpu",
                    "--workdir", str(tmp_path)]) == 2
    assert "packed_retire" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ns.main(["--small", "--workdir", str(tmp_path)]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert ns.main(["--small", "--device", "cpu", "--workdir",
                    str(tmp_path), "--require-probe-s", "0"]) == 3
