"""Reference-namespace compatibility shim (counterpart of
``sitator_tpu.compat``).

:func:`install` registers a synthetic ``sitator`` package in
``sys.modules`` whose layout mirrors the original sitator
(``github.com/Linux-cpp-lisp/sitator``), over the *port's* modules, so
unmodified sitator scripts run on PyTorch::

    import sitator_tpu_torch.compat
    sitator_tpu_torch.compat.install()

    from sitator import SiteNetwork, SiteTrajectory
    from sitator.landmark import LandmarkAnalysis
    from sitator.voronoi import VoronoiSiteGenerator
    from sitator.dynamics import JumpAnalysis, MergeSitesByDynamics
    from sitator.util import PBCCalculator

Both import styles are provided: package re-exports
(``from sitator.dynamics import JumpAnalysis``) and the original's
one-class-per-CamelCase-file modules
(``from sitator.dynamics.JumpAnalysis import JumpAnalysis``).

The shim is OPT-IN and reversible via :func:`uninstall`.  It refuses to
overwrite a real ``sitator`` distribution if one is importable, and it
refuses while the JAX package's shim (``sitator_tpu.compat``) holds the
name: one process runs one implementation under ``sitator``.  The JAX
package's shim refuses this one in turn, since the root module it finds
does not carry its own marker.

The port's engines take ``device=`` (default ``"cuda"``); scripts written
for the original run on the card unchanged, and pass ``device="cpu"`` to
run on the host.  Structures are :class:`sitator_tpu_torch.Structure`, not
ASE ``Atoms`` (use ``sitator_tpu_torch.io.ase_adapter`` when ASE is
available), and ``VoronoiSiteGenerator`` uses the built-in periodic Voronoi
rather than shelling out to Zeo++ (``sitator.util.zeo.Zeopy`` still wraps
a real binary if present).
"""
from __future__ import annotations

import importlib
import importlib.util
import sys
import types

__all__ = ["install", "uninstall", "REFERENCE_LAYOUT"]

# original module path -> (sitator_tpu_torch module, [exported symbols] |
# None for "alias the whole module"); the JAX package's table, module for
# module.
REFERENCE_LAYOUT = {
    "sitator": ("sitator_tpu_torch",
                ["SiteNetwork", "SiteTrajectory", "Structure",
                 "__version__"]),
    # one-class-per-file modules at the top level (§3.1)
    "sitator.SiteNetwork": ("sitator_tpu_torch.core.sitenet",
                            ["SiteNetwork"]),
    "sitator.SiteTrajectory": ("sitator_tpu_torch.core.sitetraj",
                               ["SiteTrajectory"]),
    "sitator.errors": ("sitator_tpu_torch.util.errors", None),
    # landmark engine (§3.2)
    "sitator.landmark": ("sitator_tpu_torch.landmark", None),
    "sitator.landmark.LandmarkAnalysis": (
        "sitator_tpu_torch.landmark.analysis", ["LandmarkAnalysis"]),
    "sitator.landmark.errors": ("sitator_tpu_torch.util.errors", None),
    "sitator.landmark.cluster": ("sitator_tpu_torch.landmark.cluster", None),
    "sitator.landmark.cluster.dotprod": (
        "sitator_tpu_torch.landmark.cluster.dotprod", None),
    "sitator.landmark.cluster.mcl": (
        "sitator_tpu_torch.landmark.cluster.mcl", None),
    # voronoi seeding (§3.3)
    "sitator.voronoi": ("sitator_tpu_torch.voronoi", None),
    "sitator.voronoi.VoronoiSiteGenerator": (
        "sitator_tpu_torch.voronoi.generator", ["VoronoiSiteGenerator"]),
    # dynamics (§3.4)
    "sitator.dynamics": ("sitator_tpu_torch.dynamics", None),
    "sitator.dynamics.JumpAnalysis": (
        "sitator_tpu_torch.dynamics.jump_analysis", ["JumpAnalysis"]),
    "sitator.dynamics.MergeSitesByDynamics": (
        "sitator_tpu_torch.dynamics.merge_dynamics",
        ["MergeSitesByDynamics"]),
    "sitator.dynamics.RemoveUnoccupiedSites": (
        "sitator_tpu_torch.dynamics.filters", ["RemoveUnoccupiedSites"]),
    "sitator.dynamics.RemoveShortJumps": (
        "sitator_tpu_torch.dynamics.filters", ["RemoveShortJumps"]),
    "sitator.dynamics.AverageVibrationalFrequency": (
        "sitator_tpu_torch.dynamics.vibrational",
        ["AverageVibrationalFrequency"]),
    "sitator.dynamics.DiffusionAnalysis": (
        "sitator_tpu_torch.dynamics.diffusion",
        ["DiffusionAnalysis", "SiteDiffusionAnalysis"]),
    # SURVEY §3.4 leaves the dynamics/network split of MergeSitesByDistance
    # unverified — expose the file-module under both parents.
    "sitator.dynamics.MergeSitesByDistance": (
        "sitator_tpu_torch.network.merging", ["MergeSitesByDistance"]),
    # network (§3.5)
    "sitator.network": ("sitator_tpu_torch.network", None),
    "sitator.network.DiffusionPathwayAnalysis": (
        "sitator_tpu_torch.network.pathways", ["DiffusionPathwayAnalysis"]),
    "sitator.network.merging": ("sitator_tpu_torch.network.merging", None),
    "sitator.network.MergeSitesByDistance": (
        "sitator_tpu_torch.network.merging", ["MergeSitesByDistance"]),
    "sitator.network.SiteVolumes": (
        "sitator_tpu_torch.network.site_volumes", ["SiteVolumes"]),
    # site descriptors (§3.6)
    "sitator.site_descriptors": ("sitator_tpu_torch.site_descriptors", None),
    "sitator.site_descriptors.SOAP": (
        "sitator_tpu_torch.site_descriptors.soap",
        ["SOAPDescriptorAverages", "SiteCentersDescriptor"]),
    "sitator.site_descriptors.SiteTypeAnalysis": (
        "sitator_tpu_torch.site_descriptors.typing", ["SiteTypeAnalysis"]),
    "sitator.site_descriptors.MergeSitesByDescriptors": (
        "sitator_tpu_torch.site_descriptors.merge_descriptors",
        ["MergeSitesByDescriptors"]),
    # util substrate (§3.7)
    "sitator.util": ("sitator_tpu_torch.util", None),
    "sitator.util.PBCCalculator": ("sitator_tpu_torch.ops.pbc",
                                   ["PBCCalculator"]),
    "sitator.util.DotProdClassifier": ("sitator_tpu_torch.util.dotprod",
                                       ["DotProdClassifier"]),
    "sitator.util.mcl": ("sitator_tpu_torch.ops.mcl", None),
    "sitator.util.zeo": ("sitator_tpu_torch.util.zeo", None),
    "sitator.util.progress": ("sitator_tpu_torch.util.progress", None),
    "sitator.util.elbow": ("sitator_tpu_torch.util.elbow", None),
    # misc + visualization (§3.8)
    "sitator.misc": ("sitator_tpu_torch.misc", None),
    "sitator.misc.NAvgsPerSite": ("sitator_tpu_torch.misc.navgs",
                                  ["NAvgsPerSite"]),
    "sitator.misc.RecenterTrajectory": ("sitator_tpu_torch.misc.recenter",
                                        ["RecenterTrajectory"]),
    "sitator.visualization": ("sitator_tpu_torch.visualization", None),
    "sitator.visualization.common": (
        "sitator_tpu_torch.visualization.common", None),
    "sitator.visualization.atoms": (
        "sitator_tpu_torch.visualization.atoms", None),
    "sitator.visualization.SiteNetworkPlotter": (
        "sitator_tpu_torch.visualization.network_plot",
        ["SiteNetworkPlotter"]),
}


def _alias_module(ref_name, target_name, symbols):
    """A fresh module object exporting ``symbols`` (or the target's whole
    public surface) — never the target module itself, so installing and
    linking the shim cannot mutate real ``sitator_tpu_torch`` modules."""
    target = importlib.import_module(target_name)
    if symbols is None:
        symbols = getattr(
            target, "__all__",
            [s for s in vars(target) if not s.startswith("_")])
    mod = types.ModuleType(ref_name)
    mod.__doc__ = (f"compat alias of {target_name} "
                   f"(sitator_tpu_torch.compat.install)")
    for s in symbols:
        setattr(mod, s, getattr(target, s))
    mod.__all__ = list(symbols)
    return mod


_MARK = "__sitator_tpu_torch_compat__"
_JAX_MARK = "__sitator_tpu_compat__"      # the JAX package's shim


def install(force=False):
    """Register the original ``sitator`` namespace in ``sys.modules``.

    Raises RuntimeError if the JAX package's shim holds ``sitator`` (call
    ``sitator_tpu.compat.uninstall()`` first), or if a real ``sitator``
    distribution is importable (pass ``force=True`` to shadow that one for
    this process anyway).  Safe to call repeatedly.
    """
    already = sys.modules.get("sitator")
    if already is not None and getattr(already, _MARK, False):
        return
    if already is not None and getattr(already, _JAX_MARK, False):
        raise RuntimeError(
            "the JAX package's shim (sitator_tpu.compat) already holds "
            "'sitator' in this process; call sitator_tpu.compat.uninstall() "
            "before installing sitator_tpu_torch.compat")
    if not force:
        if already is not None:
            raise RuntimeError(
                "a real 'sitator' module is already imported; pass "
                "force=True to shadow it for this process")
        if importlib.util.find_spec("sitator") is not None:
            raise RuntimeError(
                "a real 'sitator' distribution is installed; pass "
                "force=True to shadow it for this process")

    mods = {}
    for ref_name, (target_name, symbols) in REFERENCE_LAYOUT.items():
        mods[ref_name] = _alias_module(ref_name, target_name, symbols)
    root = mods["sitator"]
    setattr(root, _MARK, True)
    # parent attribute linkage so `import sitator.landmark.cluster` and
    # `from sitator.dynamics import JumpAnalysis` both resolve.  When a
    # CamelCase file-module collides with a re-exported class of the same
    # name (`sitator.SiteNetwork`, `sitator.dynamics.JumpAnalysis`, ...),
    # the class wins on the parent — the original's own binding order,
    # where `from .X import X` in __init__ rebinds the attribute;
    # `import sitator.X` still resolves via sys.modules.
    for ref_name, mod in mods.items():
        if "." in ref_name:
            parent, leaf = ref_name.rsplit(".", 1)
            p = mods[parent]
            if leaf not in getattr(p, "__all__", ()):
                setattr(p, leaf, mod)
    sys.modules.update(mods)


def uninstall():
    """Remove the shim (no-op on modules this shim did not install, the
    JAX package's shim included)."""
    root = sys.modules.get("sitator")
    if root is None or not getattr(root, _MARK, False):
        return
    for name in list(sys.modules):
        if name == "sitator" or name.startswith("sitator."):
            del sys.modules[name]
