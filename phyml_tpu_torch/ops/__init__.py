from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, TreeArrays
