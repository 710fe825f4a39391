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
from healnet_tpu_torch.ops.fused_chain import (
    WEIGHT_FIELDS,
    ChainSpec,
    chain_reference,
    chain_spec,
    fused_chain_kernel,
    fused_latent_chain,
    stack_chain_weights,
)
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
    "WEIGHT_FIELDS",
    "ChainSpec",
    "QuantizedContext",
    "attention_scores",
    "chain_reference",
    "chain_spec",
    "flash_cross_attention",
    "fourier_channels",
    "fourier_encode",
    "fused_chain_kernel",
    "fused_kv_project",
    "fused_latent_chain",
    "gated_gelu",
    "gated_relu",
    "gated_selu",
    "mask_value",
    "multihead_attention",
    "positional_encoding",
    "quantize_context",
    "quantize_context_host",
    "split_heads",
    "stack_chain_weights",
]
