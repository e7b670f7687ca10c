from sitator_tpu_torch.voronoi.generator import (
    VoronoiSiteGenerator,
    periodic_voronoi_nodes,
)

__all__ = ["VoronoiSiteGenerator", "periodic_voronoi_nodes"]
