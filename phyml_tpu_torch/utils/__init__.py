from phyml_tpu_torch.utils.checkpoint import Checkpointer
