from sitator_tpu_torch.dynamics.jump_analysis import JumpAnalysis
from sitator_tpu_torch.dynamics.merge_dynamics import MergeSitesByDynamics
from sitator_tpu_torch.dynamics.metastable import MergeSitesByMetastability
from sitator_tpu_torch.dynamics.markov import MarkovianityAnalysis
from sitator_tpu_torch.dynamics.uncertainty import (ChainUncertaintyAnalysis,
                                              edge_probability_intervals)
from sitator_tpu_torch.dynamics.filters import RemoveUnoccupiedSites, \
    RemoveShortJumps
from sitator_tpu_torch.dynamics.vibrational import (
    AverageVibrationalFrequency, VibrationalSpectrumAnalysis,
    ConductivitySpectrumAnalysis)
from sitator_tpu_torch.dynamics.diffusion import DiffusionAnalysis, \
    SiteDiffusionAnalysis, RelaxationAnalysis
from sitator_tpu_torch.dynamics.correlation import (RDFAnalysis,
                                              VanHoveAnalysis,
                                              ScatteringAnalysis)
from sitator_tpu_torch.dynamics.arrhenius import (ArrheniusAnalysis,
                                            EdgeArrheniusAnalysis)
from sitator_tpu_torch.dynamics.energetics import (SiteFreeEnergyAnalysis,
                                             PathwayBarrierAnalysis)
from sitator_tpu_torch.dynamics.onsager import OnsagerAnalysis
from sitator_tpu_torch.dynamics.kmc import (KineticMonteCarlo,
                                      mean_first_passage_times)
from sitator_tpu_torch.dynamics.tpt import TransitionPathAnalysis
from sitator_tpu_torch.dynamics.residence import ResidenceTimeAnalysis
from sitator_tpu_torch.dynamics.vacancy import VacancyAnalysis
from sitator_tpu_torch.dynamics.concerted import ConcertedJumpAnalysis
from sitator_tpu_torch.dynamics.balance import (
    DetailedBalanceAnalysis, OccupancyCorrelationAnalysis,
    MergeSitesByOccupancyCorrelation)
from sitator_tpu_torch.network.merging import MergeSitesByDistance

__all__ = [
    "JumpAnalysis", "MergeSitesByDynamics",
    "MergeSitesByMetastability", "MarkovianityAnalysis",
    "ChainUncertaintyAnalysis", "edge_probability_intervals",
    "MergeSitesByDistance",
    "RemoveUnoccupiedSites", "RemoveShortJumps",
    "AverageVibrationalFrequency", "VibrationalSpectrumAnalysis",
    "ConductivitySpectrumAnalysis", "DiffusionAnalysis",
    "SiteDiffusionAnalysis", "RelaxationAnalysis", "RDFAnalysis",
    "VanHoveAnalysis", "ScatteringAnalysis", "ArrheniusAnalysis",
    "SiteFreeEnergyAnalysis", "PathwayBarrierAnalysis",
    "OnsagerAnalysis",
    "KineticMonteCarlo", "TransitionPathAnalysis",
    "ResidenceTimeAnalysis",
    "EdgeArrheniusAnalysis", "mean_first_passage_times",
    "VacancyAnalysis", "ConcertedJumpAnalysis",
    "DetailedBalanceAnalysis", "OccupancyCorrelationAnalysis",
    "MergeSitesByOccupancyCorrelation",
]
