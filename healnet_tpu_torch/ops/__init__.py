from healnet_tpu_torch.ops.activations import (
    GATED_ACTIVATIONS,
    gated_gelu,
    gated_relu,
    gated_selu,
    mask_value,
)
from healnet_tpu_torch.ops.attention import (
    attention_scores,
    multihead_attention,
    split_heads,
)
from healnet_tpu_torch.ops.flash_attention import flash_cross_attention
from healnet_tpu_torch.ops.fourier import (
    fourier_channels,
    fourier_encode,
    positional_encoding,
)
from healnet_tpu_torch.ops.fused_project import fused_kv_project
from healnet_tpu_torch.ops.quantize import (
    QuantizedContext,
    quantize_context,
    quantize_context_host,
)

__all__ = [
    "GATED_ACTIVATIONS",
    "QuantizedContext",
    "attention_scores",
    "flash_cross_attention",
    "fourier_channels",
    "fourier_encode",
    "fused_kv_project",
    "gated_gelu",
    "gated_relu",
    "gated_selu",
    "mask_value",
    "multihead_attention",
    "positional_encoding",
    "quantize_context",
    "quantize_context_host",
    "split_heads",
]
