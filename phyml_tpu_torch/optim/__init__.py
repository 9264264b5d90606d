from phyml_tpu_torch.optim.blen import optimize_branch_lengths
from phyml_tpu_torch.optim.brent import brent_maximize
from phyml_tpu_torch.optim.round import round_optimize
