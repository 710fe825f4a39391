"""MCAT family baselines: MCAT, MILAttentionNet, SNN.

Counterpart of ``healnet_tpu/models/baselines/mcat.py``:

- :class:`MCAT`: a WSI bag FC net, one SNN tower per omic signature,
  single-head genomic-guided co-attention (queries the omic embeddings,
  keys and values the patch embeddings), two 2-layer transformer encoders,
  gated-attention pooling heads, concat or bilinear fusion, a linear
  classifier;
- :class:`MILAttentionNet`: attention-MIL over patch bags with gated
  attention pooling;
- :class:`SNN`: a self-normalising genomic MLP, every Linear drawn as
  :func:`~healnet_tpu_torch.models.baselines.common.max_weights_dense`.

``forward(tensors, presence=None, generator=None)`` -> logits, with
``tensors`` = ``[omic (b, feat) or (b, 1, feat), wsi (b, dim, patches)]``,
or ``(b, patches, dim)`` with ``tokens_layout``. An absent modality
(``presence`` 0) contributes zero features. The bags are pooled without
masks: zero-padded tokens count, as in JAX. ``input_shapes`` are the
tensors' per-sample shapes (for MCAT the omic entry may be a list of
shapes, one a signature).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.models.baselines.common import (
    AttnNetGated,
    BilinearFusion,
    Block,
    SNNBlock,
    TransformerEncoder,
    dropout,
    max_weights_dense,
)
from healnet_tpu_torch.models.layers import torch_dense

_SIZE_WSI = {"small": (1024, 256, 256), "big": (1024, 512, 384)}
_SIZE_OMIC = {"small": (256, 256), "big": (1024, 1024, 1024, 256)}


def _flatten_leading(x: torch.Tensor) -> torch.Tensor:
    """(b, feat) from (b, 1, feat) / (b, feat, 1) layouts."""
    return x.reshape(x.shape[0], -1) if x.ndim == 3 else x


def _is_shape(s) -> bool:
    return all(isinstance(v, int) for v in s)


def _bag_dim(shape: Sequence[int], tokens_layout: bool) -> int:
    """A bag's feature width from its per-sample shape."""
    return shape[-1] if tokens_layout else shape[0]


def _gated_pool(head: AttnNetGated, h: torch.Tensor, generator):
    """Gated-attention pooling: (attention scores, pooled features)."""
    a, h = head(h, generator)
    return a, torch.sum(torch.softmax(a, dim=1) * h, dim=1)


class MCAT(Block):
    """Multimodal Co-Attention Transformer."""

    def __init__(self, n_classes: int = 4, fusion: str = "concat", model_size_wsi: str = "small",
                 model_size_omic: str = "small", dropout: float = 0.25,
                 tokens_layout: bool = False, *, input_shapes, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if fusion not in ("concat", "bilinear"):
            raise ValueError(f"unknown fusion {fusion!r}")
        self.n_classes, self.fusion, self.dropout = n_classes, fusion, dropout
        self.tokens_layout = tokens_layout
        size, hidden = _SIZE_WSI[model_size_wsi], _SIZE_OMIC[model_size_omic]
        omic = input_shapes[0]
        sig_widths = ([math.prod(omic)] if _is_shape(omic)
                      else [math.prod(s) for s in omic])
        self.n_signatures = len(sig_widths)

        self.wsi_fc = torch_dense(size[1], _bag_dim(input_shapes[1], tokens_layout))
        # one tower per signature (single-signature names ``sig_{i}``)
        self.towers = []
        for j, width in enumerate(sig_widths):
            prefix = f"sig_{j}_" if len(sig_widths) > 1 else "sig_"
            names = []
            for i, features in enumerate(hidden):
                self.add_module(f"{prefix}{i}", SNNBlock(features, dropout=0.25,
                                                         in_features=width))
                names.append(f"{prefix}{i}")
                width = features
            self.towers.append(names)
        self.coattn_q = torch_dense(size[1], hidden[-1])
        self.coattn_k = torch_dense(size[1], size[1])
        self.coattn_v = torch_dense(size[1], size[1])
        self.path_transformer = TransformerEncoder(d_model=size[1], dropout=dropout)
        self.path_attention_head = AttnNetGated(hidden=size[2], dropout=dropout,
                                                in_features=size[1])
        self.path_rho = torch_dense(size[2], size[1])
        self.omic_transformer = TransformerEncoder(d_model=size[1], dropout=dropout)
        self.omic_attention_head = AttnNetGated(hidden=size[2], dropout=dropout,
                                                in_features=size[1])
        self.omic_rho = torch_dense(size[2], size[1])
        if fusion == "bilinear":
            self.mm = BilinearFusion(dim1=size[2], dim2=size[2], scale_dim1=8, scale_dim2=8,
                                     mmhid=size[2])
        else:
            self.mm_0 = torch_dense(size[2], size[2] * 2)
            self.mm_1 = torch_dense(size[2], size[2])
        self.classifier = torch_dense(n_classes, size[2])
        self.reset_parameters(generator)
        self.to(device)

    def forward(self, tensors, presence=None, generator: Optional[torch.Generator] = None,
                return_attention: bool = False):
        raw_omic = tensors[0]
        signatures = ([_flatten_leading(s) for s in raw_omic]
                      if isinstance(raw_omic, (list, tuple)) else [_flatten_leading(raw_omic)])
        wsi = tensors[1] if self.tokens_layout else tensors[1].transpose(1, 2)
        if presence is not None:
            signatures = [s * presence[:, 0][:, None] for s in signatures]
            wsi = wsi * presence[:, 1][:, None, None]

        h_path = dropout(F.relu(self.wsi_fc(wsi)), 0.25, generator, self.training)
        tokens = []
        for sig, names in zip(signatures, self.towers):
            h = sig
            for name in names:
                h = getattr(self, name)(h, generator)
            tokens.append(h)
        h_omic = torch.stack(tokens, dim=1)                # (b, n_sig, 256)

        # genomic-guided co-attention: omic queries over the patch tokens
        q, k, v = self.coattn_q(h_omic), self.coattn_k(h_path), self.coattn_v(h_path)
        scale = q.shape[-1] ** -0.5
        attn = torch.softmax(torch.einsum("bqd,bkd->bqk", q, k) * scale, dim=-1)
        h_coattn = torch.einsum("bqk,bkd->bqd", attn, v)

        a_path, h_p = _gated_pool(self.path_attention_head,
                                  self.path_transformer(h_coattn, generator), generator)
        h_p = dropout(F.relu(self.path_rho(h_p)), self.dropout, generator, self.training)
        a_omic, h_o = _gated_pool(self.omic_attention_head,
                                  self.omic_transformer(h_omic, generator), generator)
        h_o = dropout(F.relu(self.omic_rho(h_o)), self.dropout, generator, self.training)

        if self.fusion == "bilinear":
            h = self.mm(h_p, h_o, generator)
        else:
            h = F.relu(self.mm_0(torch.cat([h_p, h_o], dim=1)))
            h = F.relu(self.mm_1(h))
        logits = self.classifier(h)
        if return_attention:
            return logits, {"coattn": attn, "path": a_path, "omic": a_omic}
        return logits


class MILAttentionNet(Block):
    """Attention-MIL over patch bags."""

    def __init__(self, n_classes: int = 4, size_arg: str = "small", dropout: float = 0.25,
                 tokens_layout: bool = False, *, input_shapes, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.n_classes, self.dropout, self.tokens_layout = n_classes, dropout, tokens_layout
        sizes = {"small": (1024, 512, 256), "big": (1024, 512, 384)}[size_arg]
        self.fc = torch_dense(sizes[1], _bag_dim(input_shapes[0], tokens_layout))
        self.attention_net = AttnNetGated(hidden=sizes[2], dropout=dropout,
                                          in_features=sizes[1])
        self.rho = torch_dense(sizes[2], sizes[1])
        self.classifier = torch_dense(n_classes, sizes[2])
        self.reset_parameters(generator)
        self.to(device)

    def forward(self, tensors, presence=None, generator: Optional[torch.Generator] = None):
        wsi = tensors[0] if self.tokens_layout else tensors[0].transpose(1, 2)
        if presence is not None:
            wsi = wsi * presence[:, -1][:, None, None]
        h = dropout(F.relu(self.fc(wsi)), self.dropout, generator, self.training)
        _, pooled = _gated_pool(self.attention_net, h, generator)
        pooled = dropout(F.relu(self.rho(pooled)), self.dropout, generator, self.training)
        return self.classifier(pooled)


class SNN(Block):
    """Self-normalising genomic MLP (``fc_omic_{i}`` blocks, ``classifier``)."""

    def __init__(self, n_classes: int = 4, model_size_omic: str = "small", *, input_shapes,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.n_classes = n_classes
        hidden = {"small": (256, 256, 256, 256), "big": (1024, 1024, 1024, 256)}[model_size_omic]
        self.n_blocks = len(hidden)
        width = math.prod(input_shapes[0])
        for i, features in enumerate(hidden):
            self.add_module(f"fc_omic_{i}", SNNBlock(features, dropout=0.25, max_init=True,
                                                     in_features=width))
            width = features
        self.classifier = max_weights_dense(n_classes, hidden[-1])
        self.reset_parameters(generator)
        self.to(device)

    def forward(self, tensors, presence=None, generator: Optional[torch.Generator] = None):
        x = _flatten_leading(tensors[0])
        if presence is not None:
            x = x * presence[:, 0][:, None]
        for i in range(self.n_blocks):
            x = getattr(self, f"fc_omic_{i}")(x, generator)
        return self.classifier(x)
