"""Layer math and attention for the port (see ray_tpu/ops)."""

from ray_tpu_torch.ops.attention import (DEFAULT_MASK_VALUE, attention,
                                         blockwise_attention,
                                         flash_attention,
                                         flash_attention_plain,
                                         flash_attention_with_lse,
                                         mha_reference)
from ray_tpu_torch.ops.layers import (apply_rope, gelu_mlp, layer_norm,
                                      rms_norm, rope_table, swiglu)

__all__ = [
    "DEFAULT_MASK_VALUE", "attention", "blockwise_attention",
    "flash_attention", "flash_attention_plain", "flash_attention_with_lse",
    "mha_reference", "apply_rope", "gelu_mlp", "layer_norm", "rms_norm",
    "rope_table", "swiglu",
]
