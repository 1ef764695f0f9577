"""Layer math and attention for the port (see ray_tpu/ops)."""

from ray_tpu_torch.ops.attention import (DEFAULT_MASK_VALUE, attention,
                                         blockwise_attention,
                                         flash_attention,
                                         flash_attention_bwd_plain,
                                         flash_attention_plain,
                                         flash_attention_with_lse,
                                         flash_bwd_di, mha_reference)
from ray_tpu_torch.ops.layers import (apply_rope, fused_softmax_cross_entropy,
                                      gelu_mlp, layer_norm, rms_norm,
                                      rope_table, softmax_cross_entropy,
                                      swiglu)

__all__ = [
    "DEFAULT_MASK_VALUE", "attention", "blockwise_attention",
    "flash_attention", "flash_attention_bwd_plain", "flash_attention_plain",
    "flash_attention_with_lse", "flash_bwd_di", "mha_reference",
    "apply_rope", "fused_softmax_cross_entropy", "gelu_mlp", "layer_norm",
    "rms_norm", "rope_table", "softmax_cross_entropy", "swiglu",
]
