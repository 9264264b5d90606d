from phyml_tpu_torch.io.alignment import Alignment, read_alignment
from phyml_tpu_torch.io.newick import parse_newick, write_newick
