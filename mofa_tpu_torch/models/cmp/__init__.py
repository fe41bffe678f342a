from mofa_tpu_torch.models.cmp.model import (CMP, CMPConfig, TINY_CMP_CONFIG,
                                             cmp_preprocess, fuser_convert_flow)

__all__ = ["CMP", "CMPConfig", "TINY_CMP_CONFIG", "cmp_preprocess",
           "fuser_convert_flow"]
