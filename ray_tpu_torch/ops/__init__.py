"""Layer math, attention and int8 quantization for the port (see
ray_tpu/ops)."""

from ray_tpu_torch.ops.attention import (DEFAULT_MASK_VALUE, attention,
                                         blockwise_attention,
                                         flash_attention,
                                         flash_attention_bwd_plain,
                                         flash_attention_plain,
                                         flash_attention_with_lse,
                                         flash_bwd_di, mha_reference)
from ray_tpu_torch.ops.quantize import (dequantize_accumulate,
                                        dequantize_blockwise,
                                        quantization_error,
                                        quantize_blockwise)
from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                              ring_attention_sharded)
from ray_tpu_torch.ops.ulysses import (ulysses_attention,
                                       ulysses_attention_sharded)
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
    "quantize_blockwise", "dequantize_blockwise", "dequantize_accumulate",
    "quantization_error", "ring_attention", "ring_attention_sharded",
    "ulysses_attention", "ulysses_attention_sharded",
]
