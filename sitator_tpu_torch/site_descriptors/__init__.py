"""Site descriptors and what is built on them (counterpart of
``sitator_tpu.site_descriptors``): SOAP vectors per site, site typing by
descriptor clustering, and the descriptor-similarity merge."""
from sitator_tpu_torch.site_descriptors.soap import (
    SOAPDescriptorAverages,
    SiteCentersDescriptor,
    soap_descriptors,
)
from sitator_tpu_torch.site_descriptors.typing import SiteTypeAnalysis
from sitator_tpu_torch.site_descriptors.merge_descriptors import (
    MergeSitesByDescriptors,
)

__all__ = [
    "soap_descriptors", "SOAPDescriptorAverages", "SiteCentersDescriptor",
    "SiteTypeAnalysis", "MergeSitesByDescriptors",
]
