"""MOTCat: optimal-transport co-attention survival baseline.

Counterpart of ``healnet_tpu/models/baselines/motcat.py``: entropic OT in
log space with a fixed number of Sinkhorn iterations
(:func:`sinkhorn_log`, optionally unbalanced through KL-relaxed
marginals), an :class:`OTAttention` plan from the omic token onto the
patch tokens, and the MCAT scaffold around it (:class:`MOTCAT`). The plan
is computed without gradients and used as constant attention weights, as
JAX's ``stop_gradient`` uses it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.models.baselines.common import (
    AttnNetGated,
    Block,
    SNNBlock,
    TransformerEncoder,
    dropout,
)
from healnet_tpu_torch.models.baselines.mcat import _bag_dim, _gated_pool
from healnet_tpu_torch.models.layers import torch_dense


def sinkhorn_log(cost: torch.Tensor, reg: float = 0.1, n_iters: int = 50,
                 unbalanced_tau: Optional[float] = None) -> torch.Tensor:
    """Entropic-OT transport plan of a ``(..., n, m)`` cost in log space,
    uniform marginals; ``unbalanced_tau`` scales the dual updates by
    tau / (tau + reg) (KL-relaxed marginals)."""
    n, m = cost.shape[-2], cost.shape[-1]
    log_mu, log_nu = -math.log(n), -math.log(m)
    scale = 1.0 if unbalanced_tau is None else unbalanced_tau / (unbalanced_tau + reg)
    neg_c = -cost / reg
    f = torch.zeros(cost.shape[:-1], dtype=cost.dtype, device=cost.device)
    g = torch.zeros(cost.shape[:-2] + (m,), dtype=cost.dtype, device=cost.device)
    for _ in range(n_iters):
        f = scale * (log_mu - torch.logsumexp(neg_c + g[..., None, :], dim=-1))
        g = scale * (log_nu - torch.logsumexp(neg_c + f[..., :, None], dim=-2))
    return torch.exp(neg_c + f[..., :, None] + g[..., None, :])


class OTAttention(nn.Module):
    """OT co-attention: ``forward(queries (b, n, d), keys (b, m, d))`` ->
    ``(plan (b, n, m), cost)``, the squared-Euclidean cost normalised by its
    largest magnitude per batch element."""

    def __init__(self, reg: float = 0.1, n_iters: int = 50,
                 unbalanced_tau: Optional[float] = None):
        super().__init__()
        self.reg, self.n_iters, self.unbalanced_tau = reg, n_iters, unbalanced_tau

    def forward(self, queries: torch.Tensor, keys: torch.Tensor):
        sq_q = torch.sum(queries**2, dim=-1, keepdim=True)
        sq_k = torch.sum(keys**2, dim=-1, keepdim=True)
        cost = sq_q + sq_k.transpose(-1, -2) - 2.0 * torch.einsum("bnd,bmd->bnm", queries, keys)
        cost = cost / (torch.amax(torch.abs(cost), dim=(-2, -1), keepdim=True) + 1e-8)
        plan = sinkhorn_log(cost, reg=self.reg, n_iters=self.n_iters,
                            unbalanced_tau=self.unbalanced_tau)
        return plan, cost


class MOTCAT(Block):
    """OT co-attention survival model."""

    def __init__(self, n_classes: int = 4, fusion: str = "concat", dropout: float = 0.25,
                 ot_reg: float = 0.1, ot_iters: int = 50, ot_tau: Optional[float] = None,
                 tokens_layout: bool = False, *, input_shapes, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.n_classes, self.fusion, self.dropout = n_classes, fusion, dropout
        self.tokens_layout = tokens_layout
        self.wsi_fc = torch_dense(256, _bag_dim(input_shapes[1], tokens_layout))
        self.sig_0 = SNNBlock(256, dropout=0.25, in_features=math.prod(input_shapes[0]))
        self.sig_1 = SNNBlock(256, dropout=0.25, in_features=256)
        self.ot_attn = OTAttention(reg=ot_reg, n_iters=ot_iters, unbalanced_tau=ot_tau)
        self.path_transformer = TransformerEncoder(d_model=256, dropout=dropout)
        self.path_head = AttnNetGated(hidden=256, dropout=dropout, in_features=256)
        self.path_rho = torch_dense(256, 256)
        self.omic_transformer = TransformerEncoder(d_model=256, dropout=dropout)
        self.omic_head = AttnNetGated(hidden=256, dropout=dropout, in_features=256)
        self.omic_rho = torch_dense(256, 256)
        self.mm_0 = torch_dense(256, 512)
        self.mm_1 = torch_dense(256, 256)
        self.classifier = torch_dense(n_classes, 256)
        self.reset_parameters(generator)
        self.to(device)

    def forward(self, tensors, presence=None, generator: Optional[torch.Generator] = None,
                return_attention: bool = False):
        omic = tensors[0].reshape(tensors[0].shape[0], -1)
        wsi = tensors[1] if self.tokens_layout else tensors[1].transpose(1, 2)
        if presence is not None:
            omic = omic * presence[:, 0][:, None]
            wsi = wsi * presence[:, 1][:, None, None]

        h_path = dropout(F.relu(self.wsi_fc(wsi)), 0.25, generator, self.training)
        h_omic = self.sig_1(self.sig_0(omic, generator), generator)[:, None, :]   # (b, 1, 256)

        # the plan as constant attention weights: no gradient through it
        with torch.no_grad():
            plan, _ = self.ot_attn(h_omic, h_path)
        h_coattn = torch.einsum("bnm,bmd->bnd", plan, h_path)

        a_path, h_p = _gated_pool(self.path_head, self.path_transformer(h_coattn, generator),
                                  generator)
        h_p = dropout(F.relu(self.path_rho(h_p)), self.dropout, generator, self.training)
        a_omic, h_o = _gated_pool(self.omic_head, self.omic_transformer(h_omic, generator),
                                  generator)
        h_o = dropout(F.relu(self.omic_rho(h_o)), self.dropout, generator, self.training)

        h = F.relu(self.mm_0(torch.cat([h_p, h_o], dim=1)))
        h = F.relu(self.mm_1(h))
        logits = self.classifier(h)
        if return_attention:
            return logits, {"ot_plan": plan, "path": a_path, "omic": a_omic}
        return logits
