"""phyml_tpu_torch — the PyTorch/CUDA port of phyml_tpu.

The same phylogenetic maximum-likelihood engine as `phyml_tpu`, with
plain tensor code in PyTorch and the Felsenstein-pruning kernels
written by hand in CUDA C++ for Hopper (`csrc/`).  The module layout
mirrors `phyml_tpu`, so each counterpart sits at the same path.  This
package imports neither JAX nor `phyml_tpu`.
"""

__version__ = "0.1.0"

from phyml_tpu_torch.io.alignment import Alignment, read_alignment
from phyml_tpu_torch.topology import Topology
from phyml_tpu_torch.models.substitution import SubstModel
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine
