"""One rank of ``tests/test_torch_multiprocess.py``: the port's frame mesh
across the ranks of a gloo process group on the CPU.

Run as ``python -m tests._torch_mp_worker RANK WORLD SHARDS RENDEZVOUS DATA
OUT`` from the repository root, one process a rank: RANK of WORLD ranks,
SHARDS CPU shards a rank, the group met through the file RENDEZVOUS
(``file://``), the test system read from the ``.npz`` DATA, everything this
rank holds written to the ``.npz`` OUT.  It imports torch, NumPy and the
port only, and fails if ``jax`` or ``sitator_tpu`` was imported.  Every
rank makes the same collective calls in the same order; a case that must
raise records its message and the rank goes on.
"""
import datetime
import sys

import numpy as np
import torch

MID, STEEP, THR = 4.0, 3.0, 0.35
BLOCKS = ((0, 61), (61, 104))     # neither length divides 2 or 8 shards
STAT_KEYS = ("n_ij", "lag_sum", "res_sum", "res_cnt", "occ_counts",
             "last_sites", "last_res")


def raised(fn, exc):
    """The message of the ``exc`` that ``fn()`` raises; fails if it does
    not raise."""
    try:
        fn()
    except exc as e:
        return str(e)
    raise RuntimeError(f"{fn} did not raise {exc.__name__}")


def mesh_cases(rank, world, shards, out):
    """Mesh semantics, the two placements, the gather, and the errors that
    must reach every rank."""
    from sitator_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.frame_mesh(devices=["cpu"] * shards)
    out["size"] = mesh.devices.size
    out["procs"] = np.array(mesh.process_indices)
    out["local"] = np.array(mesh.local)
    out["spans"] = mesh.spans_processes
    glob = np.arange(24 * 4 * 3, dtype=np.float32).reshape(24, 4, 3)
    slab = len(glob) // world
    a = tmesh.shard_frames_local(glob[rank * slab:(rank + 1) * slab], mesh)
    b = tmesh.shard_frames(glob, mesh)
    out["local_offsets"] = np.array(a.offsets)
    out["global_offsets"] = np.array(b.offsets)
    out["local_shards"] = torch.stack(a.shards).numpy()
    out["global_shards"] = torch.stack(b.shards).numpy()
    out["gathered"] = tmesh.gather_frames(a).numpy()

    def f(v):
        return ((v * v).sum(dim=(1, 2)),)

    out["mapped"] = tmesh.gather_frames(
        tmesh.shard_map_frames(f, mesh, 1, a, n_outputs=1)[0]).numpy()
    out["asarray_error"] = raised(lambda: np.asarray(a), RuntimeError)
    # rank 0's slab is one frame longer: every rank must raise
    out["slab_error"] = raised(lambda: tmesh.shard_frames_local(
        glob[:slab + (rank == 0)], mesh), ValueError)
    scrambled = tmesh.frame_mesh(devices=["cpu"] * shards)
    scrambled.process_indices = tuple(reversed(mesh.process_indices))
    out["order_error"] = raised(lambda: tmesh.shard_frames_local(
        glob[rank * slab:(rank + 1) * slab], scrambled), ValueError)
    # the last rank names no device: every rank must raise
    out["mesh_error"] = raised(lambda: tmesh.frame_mesh(
        devices=[] if rank == world - 1 else ["cpu"]), RuntimeError)
    return mesh


def load_system(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def site_network(sy):
    from sitator_tpu_torch import SiteNetwork, Structure
    sn = SiteNetwork(Structure(sy["positions"], sy["species"], sy["cell"]),
                     sy["static_mask"], sy["mobile_mask"])
    sn.centers = sy["site_centers"]
    sn.vertices = [v[m] for v, m in zip(sy["verts"], sy["vmask"])]
    return sn


def steps(sy):
    """The three analysis steps, each as ``step(mesh, mobile, static,
    valid, carry)``, on the test system's fitted centres."""
    from sitator_tpu_torch.ops import landmark as tlm
    from sitator_tpu_torch.ops import landmark_mxu as tmx
    from sitator_tpu_torch.ops.kernel_common import kernel_cell
    from sitator_tpu_torch.parallel.pipeline import (analysis_step,
                                                     fused_analysis_step,
                                                     mxu_analysis_step)
    verts, vmask, cell = sy["verts"], sy["vmask"], sy["cell"]
    centers, active = sy["centers"], sy["active"]
    live = centers[active]
    idx = torch.as_tensor(np.flatnonzero(active), dtype=torch.int32)
    K = len(centers)
    kcell = kernel_cell(cell)
    basis = tmx.basis_from_jax(tmx.prepare_engine_basis(
        verts, vmask, sy["site_centers"], cell, midpoint=MID,
        steepness=STEEP, cutoff_shape="logistic",
        static_ref=sy["positions"][sy["static_mask"]], drift_budget=3.0),
        "cpu")
    perm = torch.as_tensor(tmx.permute_centers(live, basis))
    A = tlm.vertex_membership_matrix(verts, vmask,
                                     int(sy["static_mask"].sum()))
    cell_t = torch.as_tensor(cell, dtype=torch.float32)
    cinv = torch.as_tensor(np.linalg.inv(cell), dtype=torch.float32)
    kw = dict(midpoint=MID, steepness=STEEP, threshold=THR, active_idx=idx,
              n_sites=K)

    def mxu(mesh, mob, sta, valid, carry):
        return mxu_analysis_step(mesh, mob, sta, basis, kcell, perm,
                                 valid=valid, carry=carry, **kw)

    def fused(mesh, mob, sta, valid, carry):
        return fused_analysis_step(
            mesh, mob, sta, torch.as_tensor(verts), torch.as_tensor(vmask),
            kcell, torch.as_tensor(live), s_tile=128, mxu_bf16=False,
            full_mask=bool(vmask.all()), valid=valid, carry=carry, **kw)

    def dense(mesh, mob, sta, valid, carry):
        return analysis_step(mob, sta, A, cell_t, cinv,
                             torch.as_tensor(centers),
                             torch.as_tensor(active), MID, STEEP, THR, K,
                             valid=valid, carry=carry)

    return dict(mxu=mxu, fused=fused, dense=dense)


def step_cases(rank, world, mesh, sy, out):
    """Each step over the two blocks, the carry chained from the first to
    the second: the first block's frames placed by ``shard_frames_local``
    (each rank its slab), the second's by ``shard_frames`` (the global
    block on every rank).  Rank 0 also runs each block unmeshed."""
    from sitator_tpu_torch.ops import landmark_mxu as tmx
    from sitator_tpu_torch.ops import landmark_pallas as tlp
    from sitator_tpu_torch.parallel import mesh as tmesh

    seen = []          # (kernel, frames) of every call of K1's and K3's
    for mod, name in ((tmx, "mxu_assign_blocks"),
                      (tlp, "fused_assign_blocks")):
        def spy(mobile, *a, _real=getattr(mod, name), _name=name, **k):
            seen.append((_name, mobile.shape[0]))
            return _real(mobile, *a, **k)
        setattr(mod, name, spy)
    n_dev = mesh.devices.size
    traj = sy["traj"]
    mobile_mask, static_mask = sy["mobile_mask"], sy["static_mask"]
    for name, step in steps(sy).items():
        carry = carry1 = None
        for b, (lo, hi) in enumerate(BLOCKS):
            padded, n_valid = tmesh.pad_frames(traj[lo:hi], n_dev)
            valid = torch.arange(len(padded)) < n_valid
            mob = np.ascontiguousarray(padded[:, mobile_mask], np.float32)
            sta = np.ascontiguousarray(padded[:, static_mask], np.float32)
            if b == 0:
                slab = len(padded) // world
                mine = slice(rank * slab, (rank + 1) * slab)
                mob_s = tmesh.shard_frames_local(mob[mine], mesh)
                sta_s = tmesh.shard_frames_local(sta[mine], mesh)
            else:
                mob_s = tmesh.shard_frames(mob, mesh)
                sta_s = tmesh.shard_frames(sta, mesh)
            start = len(seen)
            labels, confs, stats = step(mesh, mob_s, sta_s, valid, carry)
            record(out, f"{name}__{b}", labels[:n_valid], confs[:n_valid],
                   stats)
            out[f"{name}__{b}__kernels"] = np.array(
                [k for k, _ in seen[start:]], dtype=str)
            out[f"{name}__{b}__frames"] = np.array(
                [f for _, f in seen[start:]], dtype=np.int64)
            carry = (stats["last_sites"], stats["last_res"])
            if rank == 0:
                labels, confs, stats = step(
                    None, torch.as_tensor(mob[:n_valid]),
                    torch.as_tensor(sta[:n_valid]), None, carry1)
                record(out, f"{name}__{b}__unmeshed", labels, confs, stats)
                carry1 = (stats["last_sites"], stats["last_res"])


def record(out, key, labels, confs, stats):
    out[f"{key}__labels"] = labels.numpy()
    out[f"{key}__confs"] = confs.numpy()
    for k in STAT_KEYS:
        out[f"{key}__{k}"] = stats[k].numpy()


def engine_cases(mesh, sy, out):
    """The engines refuse a mesh that spans processes."""
    from sitator_tpu_torch import (LandmarkAnalysis, SpmdLandmarkPipeline,
                                   StreamingLandmarkAnalysis)
    kw = dict(cutoff_midpoint=MID, cutoff_steepness=STEEP, device="cpu")
    sn = site_network(sy)
    out["engine_errors"] = np.array([
        raised(lambda: SpmdLandmarkPipeline(sn, sy["centers"], sy["active"],
                                            mesh=mesh, **kw), ValueError),
        raised(lambda: LandmarkAnalysis(mesh=mesh, verbose=False, **kw),
               ValueError),
        raised(lambda: StreamingLandmarkAnalysis(mesh=mesh, verbose=False,
                                                 **kw), ValueError)])


def main(rank, world, shards, rendezvous, data, dest):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        mesh = mesh_cases(rank, world, shards, out)
        sy = load_system(data)
        step_cases(rank, world, mesh, sy, out)
        engine_cases(mesh, sy, out)
    finally:
        dist.destroy_process_group()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "sitator_tpu"))
    if leaked:
        raise RuntimeError(f"the rank imported {leaked[:5]}")
    np.savez(dest, **out)


if __name__ == "__main__":
    r, w, s = (int(x) for x in sys.argv[1:4])
    main(r, w, s, *sys.argv[4:7])
