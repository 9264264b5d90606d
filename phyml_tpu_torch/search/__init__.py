from phyml_tpu_torch.search.bionj import bionj
from phyml_tpu_torch.search.distances import ml_pairwise_distances
