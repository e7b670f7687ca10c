"""Site-network analyses: merging, pathways, comparison, graph export,
site volumes (counterpart of ``sitator_tpu.network``; the density and
bond-valence site generators are still to port)."""
from sitator_tpu_torch.network.merging import MergeSitesBase, MergeSitesByDistance
from sitator_tpu_torch.network.pathways import DiffusionPathwayAnalysis
from sitator_tpu_torch.network.site_volumes import SiteVolumes
from sitator_tpu_torch.network.compare import (match_sites,
                                               compare_site_networks,
                                               min_image_distance_matrix)
from sitator_tpu_torch.network.graph import (to_networkx,
                                             ConductionBottleneckAnalysis)

__all__ = ["MergeSitesBase", "MergeSitesByDistance",
           "DiffusionPathwayAnalysis", "SiteVolumes",
           "match_sites", "compare_site_networks",
           "min_image_distance_matrix", "to_networkx",
           "ConductionBottleneckAnalysis"]
