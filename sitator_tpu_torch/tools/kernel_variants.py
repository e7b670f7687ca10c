"""Time variants of two hand-written kernels beside the shipped ones, on
the GPU, on the 32-frame bench block of ``chip_smoke.py``.

Run from the root of a repository checkout on a machine with the card::

    python3 -m sitator_tpu_torch.tools.kernel_variants [gather] [skew]

Each variant is a copy of a shipped source (``csrc/``) with a few lines
replaced, built with ``nvcc`` into ``build/kernel_variants/`` beside the
shipped library, loaded with ``ctypes`` (the same C entry) and timed with
CUDA events in turns (every variant, then every variant again in reverse
order); its outputs are compared with the shipped kernel's.

- ``gather``: ``lv_gather`` (K3's gather stage, bf16 output) with 4, 8 or
  16 ion rows a warp and 2, 4 or 8 warps a block.
- ``skew``: the cluster K1s (``assign_skew_wgmma``) with ``clock64`` laps in
  producer thread 0 and consumer thread 0 of every CTA, summed over the
  CTAs: the producers' tile loads, pair phase (with the next tile's
  prefetch), wait for a free slot, lv elements and hand-over; the
  consumer's wait for a full slot and its wgmma and release.  Variants:
  CTA-scope barrier waits, the consumer without its wgmma, the pair phase
  with fast ``__expf`` / ``__logf``, without transcendentals, without
  its shared-memory loads or stores, and without the pair phase.  All but
  the first change the results.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "sitator_tpu_torch" / "csrc"
OUT = ROOT / "build" / "kernel_variants"
_P, _I = ctypes.c_void_p, ctypes.c_int


def _source(name):
    """A shipped source with its includes pointing back into ``csrc/``."""
    s = (CSRC / name).read_text()
    for h in ("landmark_common.cuh", "hopper_common.cuh"):
        s = s.replace(f'#include "{h}"', f'#include "{CSRC / h}"')
    return s


def _patch(src, edits):
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant anchor not found: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _build(variants, argtypes, entry):
    """nvcc every variant source in parallel; returns {name: CDLL}."""
    from sitator_tpu_torch.ops import _cuda
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-o", str(cu.with_suffix(".so")),
             str(cu)], stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        getattr(lib, entry).argtypes = argtypes
        libs[name] = lib
    return libs


def _in_turns(names, step):
    for order in (names, names[::-1]):
        for name in order:
            step(name)


def gather_variants(sy):
    import chip_smoke as cs
    from sitator_tpu_torch.ops import _cuda
    from sitator_tpu_torch.ops import landmark_pallas as lp
    from sitator_tpu_torch.ops.kernel_common import kernel_cell
    src = _source("lv_gather.cu")
    variants = {
        f"gather_R{r}W{w}": _patch(src, [
            ("constexpr int R = 8;", f"constexpr int R = {r};"),
            ("constexpr int WARPS = 4;", f"constexpr int WARPS = {w};")])
        for r in (4, 8, 16) for w in (2, 4, 8)}
    libs = _build(variants, [_P] * 6 + [_I] * 4 + [_P, _I, _I, _I, _P],
                  "sit_lv_gather")
    a = lp._gather_inputs(
        torch.as_tensor(sy["mobile"], device="cuda"),
        torch.as_tensor(sy["static"], device="cuda"), sy["verts"],
        np.ones_like(sy["verts"], bool), kernel_cell(sy["cell"]),
        sy["random_centres"], midpoint=cs.MID, steepness=cs.STEEP,
        threshold=cs.THR, s_tile=256, cutoff_shape=cs.CUTOFF,
        full_mask=True)
    B, _, MP = a["mob"].shape
    V, SP = a["vp"].shape[2:]
    p = _cuda._host_params(a["params"])
    ref_b, ref_i = cs.gather_rows(a, True)

    def step(name):
        lvb, inv = torch.empty_like(ref_b), torch.empty_like(ref_i)

        def run():
            err = libs[name].sit_lv_gather(
                a["mob"].data_ptr(), a["vp"].data_ptr(), a["mask"].data_ptr(),
                None, lvb.data_ptr(), inv.data_ptr(), B, MP, V, SP,
                p.data_ptr(), int(a["triclinic"]), int(a["r2_cutoff"]),
                int(a["full_mask"]), _cuda._stream())
            assert err == 0, err
        run()
        torch.cuda.synchronize()
        same = (torch.equal(lvb.view(torch.int16), ref_b.view(torch.int16))
                and torch.equal(inv, ref_i))
        print(f"{name}: {cs.timed(run, 10):.3f} ms; equal to the shipped "
              f"kernel: {same}", flush=True)
    _in_turns(list(libs), step)


_LAPS = ["tile loads", "pair phase", "slot wait", "lv elements",
         "hand-over"]


def _skew_timers(src):
    """The shipped K1s source with the phase laps."""
    lap = ("      { long long t1 = clock64(); lap[{i}] += t1 - t0; "
           "t0 = t1; }\n")
    return _patch(src, [
        ("namespace {\n", "__device__ unsigned long long laps[8];\n"
                          "namespace {\n"),
        ("    int g = 0;\n    for (int t = 0; t < n_st; ++t) {",
         "    int g = 0;\n    unsigned long long lap[5] = {0, 0, 0, 0, 0};\n"
         "    long long t0 = clock64();\n"
         "    for (int t = 0; t < n_st; ++t) {"),
        ("      producer_sync();   // tile t's atoms, lists and ions are in "
         "place\n",
         "      producer_sync();   // tile t's atoms, lists and ions are in "
         "place\n" + lap.replace("{i}", "0")),
        ("      const float* kl = kill + (size_t)t * s_tile;\n",
         lap.replace("{i}", "1")
         + "      const float* kl = kill + (size_t)t * s_tile;\n"),
        ("        // columns lane and lane + 32 of the stage",
         "  " + lap.replace("{i}", "2")
         + "        // columns lane and lane + 32 of the stage"),
        ("        fence_proxy_async();   // the slice, to wgmma and the bulk "
         "copies\n",
         "  " + lap.replace("{i}", "3")
         + "        fence_proxy_async();   // the slice, to wgmma and the "
           "bulk copies\n"),
        ("                              cluster_addr(fb, peer));\n"
         "          }\n        }\n",
         "                              cluster_addr(fb, peer));\n"
         "          }\n        }\n  " + lap.replace("{i}", "4")),
        ("    // inv_norm of this warp's rows, row_prep's reduction, into "
         "every CTA\n",
         "    if (p == 0)\n      for (int i = 0; i < 5; ++i) "
         "atomicAdd(&laps[i], lap[i]);\n"
         "    // inv_norm of this warp's rows, row_prep's reduction, into "
         "every CTA\n"),
        ("  for (int g = 0; g < n_kt; ++g) {\n    const int slot = g % "
         "stages;\n    mbar_wait_cluster(&full[slot], (g / stages) & 1);\n",
         "  unsigned long long cw = 0, cm = 0;\n  long long c0 = clock64();\n"
         "  for (int g = 0; g < n_kt; ++g) {\n    const int slot = g % "
         "stages;\n    mbar_wait_cluster(&full[slot], (g / stages) & 1);\n"
         "    { long long c1 = clock64(); cw += c1 - c0; c0 = c1; }\n"),
        ("          cluster_addr(smem_u32(&empty[(g - 1) % stages]), tid));\n"
         "  }\n",
         "          cluster_addr(smem_u32(&empty[(g - 1) % stages]), tid));\n"
         "    { long long c1 = clock64(); cm += c1 - c0; c0 = c1; }\n  }\n"
         "  if (tid == 0) {\n    atomicAdd(&laps[5], cw);\n"
         "    atomicAdd(&laps[6], cm);\n    atomicAdd(&laps[7], 1ull);\n"
         "  }\n"),
    ]) + """
extern "C" int sit_laps(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[8] = {0};
    return (int)cudaMemcpyToSymbol(laps, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, laps, sizeof(laps));
}
"""


def skew_variants(sy):
    import chip_smoke as cs
    from sitator_tpu_torch.ops import _cuda
    from sitator_tpu_torch.ops import landmark_mxu as mx
    from sitator_tpu_torch.ops.kernel_common import kernel_cell
    base = _skew_timers(_source("assign_skew_wgmma.cu"))
    call = "logc[r * UP + k] = unique_atom_log_factor("

    def factor(body):
        """The pair phase with its own log factor of the same arguments."""
        fn = ("__device__ float variant_factor(float x, float y, float z, "
              "float ux, float uy, float uz, const CellParams& P, int r2, "
              "int preshift) {\n  float dx = x - ux, dy = y - uy, "
              "dz = z - uz;\n  if (!preshift) min_image(dx, dy, dz, P);\n"
              "  const float v = cutoff_arg(dist2(dx, dy, dz), P, r2);\n"
              f"  return {body};\n}}\n")
        return _patch(base, [("namespace {\n", fn + "namespace {\n"),
                             (call, "logc[r * UP + k] = variant_factor(")])
    variants = {
        "skew_shipped": base,
        "skew_cta_waits": base.replace("mbar_wait_cluster(", "mbar_wait("),
        "skew_no_wgmma": _patch(base, [(
            "      wgmma_m64n256k16(d, smem_desc(a + kk * 16), "
            "smem_desc(bb + kk * 16));", "      ;")]),
        "skew_fast_exp_log": factor(
            "-(fmaxf(v, 0.0f) + __logf(1.0f + __expf(-fabsf(v))))"),
        "skew_no_transcendentals": factor("-1e-3f * v"),
        "skew_no_pair_phase": _patch(base, [(
            "k = nu ? p % nu : 0; r < RC;)", "k = nu ? p % nu : 0; r < 0;)")]),
        "skew_pair_no_loads": _patch(base, [(
            "sx[r], sy[r], sz[r], ux[k], uy[k], uz[k], P, r2, preshift);",
            "1.0f + r, 2.0f, 3.0f, 0.5f * k, 1.0f, 0.0f, P, r2, preshift);")]),
        "skew_pair_no_stores": _patch(base, [
            ("      for (int r = nu ? p / nu : RC",
             "      float sink = 0.0f;\n      for (int r = nu ? p / nu : RC"),
            (call, "sink += unique_atom_log_factor("),
            ("      producer_sync();   // logc is complete; the atoms are free",
             "      if (sink == 12345.0f) logc[0] = sink;\n"
             "      producer_sync();   // logc is complete; the atoms are free")]),
    }
    libs = _build(variants, [_P] * 12 + [_I] * 8 + [_P, _I, _I, _I, _P],
                  "sit_assign_skew_wgmma")
    for lib in libs.values():
        lib.sit_laps.argtypes = [_P, _I]
    basis = mx.basis_from_jax(mx.prepare_engine_basis(
        sy["verts"], np.ones_like(sy["verts"], bool), sy["site_pos"],
        sy["cell"], midpoint=cs.MID, steepness=cs.STEEP,
        cutoff_shape=cs.CUTOFF, static_ref=sy["static_ref"],
        drift_budget=3.0), "cuda")
    a = mx._assign_inputs(
        torch.as_tensor(sy["mobile"], device="cuda"),
        torch.as_tensor(sy["static"], device="cuda"), basis,
        kernel_cell(sy["cell"]), mx.permute_centers(sy["random_centres"],
                                                    basis),
        midpoint=cs.MID, steepness=cs.STEEP, threshold=cs.THR,
        cutoff_shape=cs.CUTOFF)
    midx, mmul = a["members"]
    cb = _cuda.centers_bf16(a["cpad"])
    B, _, MP = a["mob"].shape
    n_st, s_tile, vmax = midx.shape
    UP, KP = a["vpu"].shape[-1], cb.shape[0]
    tile_nu = (midx.amax(dim=(1, 2)) + 1).to(torch.int32)
    p = _cuda._host_params(a["params"])
    ref = _cuda.assign_skew_wgmma(
        a["mob"], a["vpu"], midx, mmul, a["kill"], a["anchors"], cb,
        a["params"], triclinic=a["triclinic"], r2_cutoff=a["r2_cutoff"],
        preshift=a["preshift"])
    spare = torch.empty(1, device="cuda")
    spare_i = torch.empty(1, device="cuda", dtype=torch.int32)

    def step(name):
        lib = libs[name]
        labels, confs = torch.empty_like(ref[0]), torch.empty_like(ref[1])

        def run():
            err = lib.sit_assign_skew_wgmma(
                a["mob"].data_ptr(), a["vpu"].data_ptr(), midx.data_ptr(),
                mmul.data_ptr(), a["kill"].data_ptr(),
                a["anchors"].data_ptr(), tile_nu.data_ptr(), cb.data_ptr(),
                labels.data_ptr(), confs.data_ptr(), spare.data_ptr(),
                spare_i.data_ptr(), B, MP, n_st, UP, s_tile, vmax, KP,
                _cuda.skew_cluster_size(KP), p.data_ptr(),
                int(a["triclinic"]), int(a["r2_cutoff"]),
                int(a["preshift"]), _cuda._stream())
            assert err == 0, err
        run()
        torch.cuda.synchronize()
        same = (torch.equal(labels, ref[0])
                and torch.equal(confs.view(torch.int32),
                                ref[1].view(torch.int32)))
        lib.sit_laps(None, 1)
        ms = cs.timed(run, 3)            # one warm-up and three timed runs
        out = (ctypes.c_ulonglong * 8)()
        lib.sit_laps(ctypes.addressof(out), 0)
        v = np.array(out[:], np.float64) / 4
        n = v[7]
        tot = v[:5].sum()
        print(f"{name}: {ms:.3f} ms; equal to the shipped kernel: {same}; "
              "producer thread 0, cycles a CTA: " + ", ".join(
                  f"{k} {v[i] / n:.0f} ({100 * v[i] / tot:.1f}%)"
                  for i, k in enumerate(_LAPS))
              + f"; consumer: full-slot wait {v[5] / n:.0f}, wgmma and "
              f"release {v[6] / n:.0f}; {int(n)} CTAs, "
              f"{n_st * s_tile // 64} stages a CTA", flush=True)
    _in_turns(list(libs), step)


def main(argv):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("kernel_variants needs a GPU", file=sys.stderr)
        return 1
    cs.phase_device()
    sy = cs.bench_system(32, seed=7)
    which = argv or ["gather", "skew"]
    if "gather" in which:
        gather_variants(sy)
    if "skew" in which:
        skew_variants(sy)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
