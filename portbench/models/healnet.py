"""The port's HealNet module for a config, as the port's pipeline builds it
for two modalities: the omic vector and the slide's patch bag."""

from __future__ import annotations

import torch

from healnet_tpu_torch.models.healnet import HealNetModule

DTYPES = {"bf16": torch.bfloat16, "f32": None}


def build(cfg: dict, device) -> HealNetModule:
    return HealNetModule(
        n_modalities=2, channel_dims=(cfg["omic_dim"], cfg["wsi_dim"]), num_spatial_axes=(1, 1),
        out_dims=cfg["output_dims"], depth=cfg["depth"], num_freq_bands=cfg["num_freq_bands"],
        max_freq=cfg["max_freq"], l_c=cfg["num_latents"], l_d=cfg["latent_dim"],
        x_heads=cfg["cross_heads"], l_heads=cfg["latent_heads"],
        cross_dim_head=cfg["cross_dim_head"], latent_dim_head=cfg["latent_dim_head"],
        attn_dropout=cfg["attn_dropout"], ff_dropout=cfg["ff_dropout"],
        weight_tie_layers=cfg["weight_tie_layers"], fourier_encode_data=cfg["fourier_encode_data"],
        self_per_cross_attn=cfg["self_per_cross_attn"], final_classifier_head=True,
        snn=cfg["snn"], attention_impl="auto", projection_impl="auto",
        dtype=DTYPES[cfg["precision"]], device=device)
