"""Plain PyTorch reference of HealNet survival training, in float32.

HealNet (Hemker et al., arXiv:2311.09115) as the tuned release configures
it: a latent array of ``num_latents`` x ``latent_dim`` updated, layer by
layer and modality by modality, by a pre-norm cross-attention over the
modality's tokens (one head family, temperature 0.5, keys and values from
a LayerNorm over the tokens and their Fourier encoding) and a pre-norm
SNN feed-forward (Linear -> x * SELU(gates) -> Linear), each added as a
residual; then mean over latents -> LayerNorm -> Linear to the survival
bins. The loss is the discrete-time NLL with censoring and normalised
class weights (alpha 0.4), over ``gc_compat``, plus ``l1`` times the sum of
every parameter's absolute value (whose slope at 0 is +1). The update is
Adam (eps outside the square root, bias correction with the step's beta1)
with OneCycle's cosine lr and beta1 over a horizon of at least 5 steps.

Dropout in training: on the normalised attention probabilities, the keep
mask of :mod:`portbench.reference.hash` under a 32-bit seed per call; on
each feed-forward output, ``torch.rand(b, latents, dim) < 1 - rate`` from a
generator on the inputs' device; kept values divided by ``1 - rate``.

Parameters are a dict of tensors named as the port's ``state_dict``. The
context projection is written in its folded form, ``x_hat @ (s . W^T) + b @
W^T`` for the LayerNorm ``(s, b)`` of normalised tokens ``x_hat``, which is
the same function as ``(x_hat * s + b) @ W^T``. Departures from the
published model: none beyond the release's own choices above.

``mm`` is the one product every matrix product goes through: plain
float32, or :func:`fp8_mm`, which rounds both operands to float8 (e4m3,
one scale a tensor) and the incoming gradient to e5m2, the precision a
cheaper training path would use.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.hash import keep_mask

FILL = -0.5 * float(torch.finfo(torch.float32).max)
EPS = 1e-5


def strict_float32() -> None:
    """Products in full float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _to_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scale = torch.finfo(dtype).max / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _to_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2)


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_Fp8Round.apply(a), _Fp8Round.apply(b))


#: the control's product: the precision below the config's bf16
control_mm = fp8_mm


def layer_norm(x, weight=None, bias=None):
    mu = x.mean(-1, keepdim=True)
    y = (x - mu) / torch.sqrt(((x - mu) ** 2).mean(-1, keepdim=True) + EPS)
    return y if weight is None else y * weight + bias


def fourier(width: int, max_freq: float, bands: int, device) -> torch.Tensor:
    """(width, 2 * bands + 1): [sin, cos, position] of positions linspace(-1, 1)."""
    pos = torch.linspace(-1.0, 1.0, width, device=device)[:, None]
    scaled = pos * torch.linspace(1.0, max_freq / 2.0, bands, device=device) * math.pi
    return torch.cat([torch.sin(scaled), torch.cos(scaled), pos], dim=-1)


def abs_(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, -x)


def attention_calls(cfg: dict) -> int:
    """Hash seeds a training step draws: one a cross-attention call (depth x
    two modalities), none without attention dropout."""
    return cfg["depth"] * 2 if cfg["attn_dropout"] > 0 else 0


def check_supported(cfg: dict) -> None:
    if cfg["self_per_cross_attn"] or cfg["weight_tie_layers"] or not cfg["snn"] \
            or not cfg["fourier_encode_data"]:
        raise ValueError("this reference covers untied SNN HealNet with Fourier encodings "
                         "and no latent self-attention")


def forward(p: Dict[str, torch.Tensor], cfg: dict, omic: torch.Tensor, slide: torch.Tensor,
            mask: torch.Tensor, *, train: bool = False, seeds: Sequence[int] = (),
            ff_gen: Optional[torch.Generator] = None, mm: Callable = torch.matmul,
            alter: float = 0.0) -> torch.Tensor:
    """Logits (b, output_dims) of omic (b, 1, omic_dim) and a slide (b, width,
    wsi_dim) whose tokens past each bag are zero and masked by ``mask``
    (b, width). ``alter`` is added to row 0's logits (a planted fault)."""
    check_supported(cfg)
    b, dev = omic.shape[0], omic.device
    heads, d = cfg["cross_heads"], cfg["cross_dim_head"]
    inner, lc, ld = heads * d, cfg["num_latents"], cfg["latent_dim"]
    attn_rate = cfg["attn_dropout"] if train else 0.0
    ff_rate = cfg["ff_dropout"] if train else 0.0
    contexts = []
    for ctx, kmask in ((omic, None), (slide, mask)):
        enc = fourier(ctx.shape[1], cfg["max_freq"], cfg["num_freq_bands"], dev)
        x = torch.cat([ctx, enc.expand(b, *enc.shape)], dim=-1)
        contexts.append((layer_norm(x), kmask))
    seeds = iter(seeds)
    x = p["latents"].expand(b, lc, ld)
    for layer in range(cfg["depth"]):
        for m, (xhat, kmask) in enumerate(contexts):
            pre = f"layer{layer}_cross_attn_m{m}."
            w_kv = p[pre + "fn.to_kv.weight"]
            kv = mm(xhat, w_kv.t() * p[pre + "norm_context.weight"][:, None]) \
                + (p[pre + "norm_context.bias"][:, None] * w_kv.t()).sum(0)
            n = kv.shape[1]
            kh, vh = (t.reshape(b, n, heads, d).transpose(1, 2) for t in kv.split(inner, -1))
            q = mm(layer_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"]),
                   p[pre + "fn.to_q.weight"].t())
            qh = q.reshape(b, lc, heads, d).transpose(1, 2)
            sim = mm(qh, kh.transpose(-1, -2)) * (d ** -0.5 / 0.5)
            if kmask is not None:
                sim = sim.masked_fill(~kmask[:, None, None, :], FILL)
            attn = torch.softmax(sim, dim=-1)
            if kmask is not None:
                attn = attn * kmask.any(-1)[:, None, None, None]
            if attn_rate > 0:
                keep = keep_mask(next(seeds), b, heads, lc, n, attn_rate, dev)
                attn = torch.where(keep, attn / (1.0 - attn_rate), torch.zeros_like(attn))
            out = mm(attn, vh).transpose(1, 2).reshape(b, lc, inner)
            x = F.leaky_relu(mm(out, p[pre + "fn.to_out.weight"].t()) + p[pre + "fn.to_out.bias"],
                             negative_slope=1e-2) + x
            pre = f"layer{layer}_cross_ff_m{m}."
            h = mm(layer_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"]),
                   p[pre + "fn.net_0.weight"].t()) + p[pre + "fn.net_0.bias"]
            h_x, gates = h.chunk(2, dim=-1)
            h = mm(h_x * F.selu(gates), p[pre + "fn.net_2.weight"].t()) + p[pre + "fn.net_2.bias"]
            if ff_rate > 0:
                keep = torch.rand((b, lc, ld), generator=ff_gen, device=dev) < 1.0 - ff_rate
                h = torch.where(keep, h / (1.0 - ff_rate), torch.zeros_like(h))
            x = h + x
    pooled = layer_norm(x.mean(dim=1), p["final_norm.weight"], p["final_norm.bias"])
    logits = mm(pooled, p["final_head.weight"].t()) + p["final_head.bias"]
    if alter:
        logits = logits + alter * (torch.arange(b, device=dev) == 0)[:, None]
    return logits


def nll_rows(logits, y, c, class_weights, alpha: float = 0.4, eps: float = 1e-7):
    """Per-row discrete-time survival NLL (b,)."""
    hazards = torch.sigmoid(logits)
    surv = torch.cumprod(1.0 - hazards, dim=1)
    s_pad = torch.cat([torch.ones_like(surv[:, :1]), surv], dim=1)
    y, c = y.long()[:, None], c.float()[:, None]
    uncensored = -(1.0 - c) * (torch.log(torch.clamp(s_pad.gather(1, y), min=eps))
                               + torch.log(torch.clamp(hazards.gather(1, y), min=eps)))
    neg = uncensored - c * torch.log(torch.clamp(s_pad.gather(1, y + 1), min=eps))
    if class_weights is not None:
        neg = neg * (class_weights / class_weights.sum())[y]
    return ((1.0 - alpha) * neg + alpha * uncensored)[:, 0]


def onecycle(count: int, horizon: float, max_lr: float, pct: float = 0.3):
    """(lr, beta1) of the update after ``count`` updates, OneCycle's cosine
    shapes (div 25, final div 1e4, beta1 0.95 -> 0.85 -> 0.95)."""
    frac = min(max(count / max(horizon, math.ceil(1.0 / pct) + 1), 0.0), 1.0)
    t1, t2 = min(frac / pct, 1.0), min(max((frac - pct) / (1.0 - pct), 0.0), 1.0)
    init = max_lr / 25.0
    cos = lambda t: 0.5 * (1.0 - math.cos(math.pi * t))
    if frac < pct:
        return init + (max_lr - init) * cos(t1), 0.95 + (0.85 - 0.95) * cos(t1)
    return max_lr + (init / 1e4 - max_lr) * cos(t2), 0.85 + (0.95 - 0.85) * cos(t2)


class Trainer:
    """The reference's training state: parameters, Adam moments and count."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, *, horizon: float,
                 class_weights: Optional[torch.Tensor], mm: Callable = torch.matmul,
                 alter: float = 0.0, half_batch: bool = False):
        self.p = {k: v.detach().float().clone() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.cfg, self.horizon, self.count = cfg, horizon, 0
        self.cw, self.mm, self.alter, self.half_batch = class_weights, mm, alter, half_batch

    def _weights(self, sample_mask: torch.Tensor) -> torch.Tensor:
        w = sample_mask.float()
        if self.half_batch:  # planted fault: the second half of the batch left out
            w = w * (torch.arange(w.shape[0], device=w.device) < w.shape[0] // 2)
        return w

    def step(self, batch: dict, seeds: Sequence[int], ff_seed: int):
        """One update; returns (survival loss, the gradients by name)."""
        leaves = {k: v.requires_grad_(True) for k, v in self.p.items()}
        gen = torch.Generator(device=batch["omic"].device).manual_seed(int(ff_seed))
        logits = forward(leaves, self.cfg, batch["omic"], batch["slide"], batch["mask"],
                         train=True, seeds=seeds, ff_gen=gen, mm=self.mm, alter=self.alter)
        w = self._weights(batch["sample_mask"])
        rows = nll_rows(logits, batch["y_disc"], batch["censorship"], self.cw)
        loss = (rows * w).sum() / w.sum().clamp(min=1.0)
        total = loss / self.cfg["gc_compat"] + self.cfg["l1"] * sum(
            abs_(v).sum() for v in leaves.values())
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
        self._adam(grads)
        return float(loss.detach()), grads

    @torch.no_grad()
    def _adam(self, grads) -> None:
        lr, b1 = onecycle(self.count, self.horizon, self.cfg["max_lr"])
        self.count += 1
        b2, t = 0.999, self.count
        for k, p in self.p.items():
            p.requires_grad_(False)
            self.m[k].mul_(b1).add_(grads[k], alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(grads[k], grads[k], value=1.0 - b2)
            denom = self.v[k].sqrt() / math.sqrt(1.0 - b2 ** t) + 1e-8
            p.sub_(lr / (1.0 - b1 ** t) * self.m[k] / denom)

    @torch.no_grad()
    def val_loss(self, batches: List[dict]) -> float:
        """Mean survival loss over the valid rows of evaluation batches."""
        total, count = 0.0, 0.0
        for batch in batches:
            logits = forward(self.p, self.cfg, batch["omic"], batch["slide"], batch["mask"],
                             mm=self.mm, alter=self.alter)
            w = batch["sample_mask"].float()
            total += float((nll_rows(logits, batch["y_disc"], batch["censorship"], self.cw)
                            * w).sum())
            count += float(w.sum())
        return total / max(count, 1.0)
