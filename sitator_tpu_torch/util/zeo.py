"""``Zeopy`` — optional wrapper for an external Zeo++ ``network`` binary
(counterpart of ``sitator_tpu.util.zeo``; host code, no device work).

The original sitator *requires* Zeo++ for its Voronoi decomposition; this
package ships a native one (:mod:`sitator_tpu_torch.voronoi`) and does not.
This wrapper exists for users who have Zeo++ installed and want its
decomposition instead: it writes the structure in CSSR form, invokes
``network -nt2``, and parses the resulting Voronoi net.  Without the binary
it raises :class:`ZeoppNotFoundError` with a pointer to the native path.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np


class ZeoppNotFoundError(RuntimeError):
    pass


class Zeopy:
    """Context manager around the Zeo++ ``network`` executable."""

    def __init__(self, executable="network"):
        self.executable = executable
        self._dir = None

    def __enter__(self):
        if shutil.which(self.executable) is None:
            raise ZeoppNotFoundError(
                f"Zeo++ executable {self.executable!r} not found. "
                "sitator_tpu_torch does not require Zeo++ — use "
                "sitator_tpu_torch.voronoi.VoronoiSiteGenerator (native "
                "periodic Voronoi) instead.")
        self._dir = tempfile.mkdtemp(prefix="zeopy_")
        return self

    def __exit__(self, *exc):
        if self._dir:
            shutil.rmtree(self._dir, ignore_errors=True)
        return False

    def voronoi(self, structure, radial=False, radii=None):
        """Run the Voronoi decomposition of a Structure.  Returns
        (nodes (N, 3), vertex index lists, node radii)."""
        cssr = os.path.join(self._dir, "structure.cssr")
        out = os.path.join(self._dir, "structure.nt2")
        self._write_cssr(structure, cssr)
        cmd = [self.executable]
        if radial and radii is not None:
            rad_file = os.path.join(self._dir, "radii.rad")
            with open(rad_file, "w") as f:
                for sym, r in radii.items():
                    f.write(f"{sym} {r}\n")
            cmd += ["-r", rad_file]
        elif not radial:
            cmd += ["-nor"]
        cmd += ["-nt2", out, cssr]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"Zeo++ failed: {res.stderr[-2000:]}")
        return self._parse_nt2(out, structure)

    @staticmethod
    def _write_cssr(structure, path):
        # CSSR expects cell lengths+angles (shared conversion with the
        # CIF writer; clip-guarded against acos domain spill)
        from sitator_tpu_torch.core.structure import cell_to_parameters
        a, b, c, alpha, beta, gamma = cell_to_parameters(structure.cell)
        frac = structure.frac_positions % 1.0
        with open(path, "w") as f:
            f.write(f"{a:.6f} {b:.6f} {c:.6f}\n")
            f.write(f"{alpha:.4f} {beta:.4f} {gamma:.4f} SPGR= 1 P1\n")
            f.write(f"{structure.n_atoms} 0\n0 sitator_tpu\n")
            for i, (sym, p) in enumerate(zip(structure.symbols, frac), 1):
                f.write(f"{i} {sym} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        "0 0 0 0 0 0 0 0 0.0\n")

    @staticmethod
    def _parse_nt2(path, structure):
        """EXPERIMENTAL: .nt2 Voronoi-network parser.

        Written against the documented Zeo++ ``network -nt2`` layout —
        a ``Vertex table:`` section of ``<id> <x> <y> <z> <radius>
        <atom ids...>`` lines followed by an ``Edge table:`` section —
        but never validated against real binary output (no Zeo++ in this
        environment — SURVEY.md §0).  Files without the section markers
        fall back to sniffing vertex-shaped lines.  The atom-id base
        (Zeo++ builds vary between 0- and 1-based) is auto-detected from
        coverage of ``structure``: in a full Voronoi decomposition every
        atom anchors some node, so the min/max id over the whole file
        identify the convention.  If you have Zeo++, verify one
        decomposition against ``VoronoiSiteGenerator`` before trusting
        this, and prefer the native generator in any case.
        """
        import warnings
        warnings.warn(
            "Zeopy._parse_nt2 is experimental (never validated against real "
            "Zeo++ output); cross-check against "
            "sitator_tpu_torch.voronoi.VoronoiSiteGenerator",
            stacklevel=2)
        nodes = []
        verts_raw = []
        radii = []
        with open(path) as f:
            lines = f.readlines()

        def try_vertex(parts):
            """Parse one `<id> <x> <y> <z> <r> <atom ids...>` line."""
            if parts and parts[0] == "Vertex":   # tolerated variant prefix
                parts = parts[1:]
            if len(parts) < 5 or not parts[0].lstrip("-").isdigit():
                return False
            try:
                xyz = [float(parts[1]), float(parts[2]), float(parts[3])]
                rad = float(parts[4])
            except ValueError:
                return False
            nodes.append(xyz)
            radii.append(rad)
            verts_raw.append([int(x) for x in parts[5:] if x.isdigit()])
            return True

        # primary: the documented section markers
        low = [ln.strip().lower() for ln in lines]
        if any(ln.startswith("vertex table") for ln in low):
            in_vertices = False
            for ln, lo in zip(lines, low):
                if lo.startswith("vertex table"):
                    in_vertices = True
                    continue
                if lo.startswith("edge table"):
                    break
                if in_vertices and ln.split():
                    try_vertex(ln.split())
        else:
            # fallback: sniff contiguous vertex-shaped lines
            in_nodes = False
            for ln in lines:
                parts = ln.split()
                if not parts:
                    continue
                if try_vertex(parts):
                    in_nodes = True
                elif in_nodes:
                    break

        # atom-id base detection: an id of 0 proves 0-based; an id equal
        # to n_atoms proves 1-based (0-based tops out at n_atoms - 1)
        all_ids = [i for v in verts_raw for i in v]
        offset = 1
        if all_ids:
            lo_id, hi_id = min(all_ids), max(all_ids)
            if hi_id > structure.n_atoms or (lo_id == 0
                                             and hi_id == structure.n_atoms):
                # ids past n_atoms, or a file claiming BOTH 0-based (id 0)
                # and 1-based (id n_atoms) conventions at once
                raise ValueError(
                    f"nt2 atom ids span [{lo_id}, {hi_id}] but the "
                    f"structure has {structure.n_atoms} atoms — not a "
                    "decomposition of this structure?")
            if lo_id == 0:
                offset = 0
            elif hi_id < structure.n_atoms:
                # ambiguous (ids within [1, n_atoms - 1] only — e.g. a
                # partial decomposition): keep the 1-based assumption of
                # the released 0.2.0 parser (which always subtracted 1),
                # but say so
                warnings.warn(
                    "nt2 atom-id base is ambiguous (no id 0, none equal "
                    "to n_atoms); assuming 1-based ids", stacklevel=2)
        verts = [np.array([i - offset for i in v], dtype=np.int32)
                 for v in verts_raw]
        return (np.asarray(nodes), verts, np.asarray(radii))
