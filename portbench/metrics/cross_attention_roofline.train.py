"""cross_attention_roofline.train (%, kernels): the bound of one
cross-attention module over a slide at the widest bucket, forward and
backward with the config's dropout (``portbench/counts.py::attention_cost``),
over its device time through the model's own ``Attention`` module (layer 0,
the slide) in training mode, captured in a graph and replayed. It reads the
same work whichever path (plain or flash) the module dispatches to."""

import torch

from portbench.counts import attention_cost, bound_s
from portbench.program import twin
from portbench.timing import graph_ms


def work(ctx):
    """(one forward and backward, its operations, its bytes)."""
    cfg = ctx.cfg
    mask = ctx.cohort.gather(ctx.cohort.widest_batch())[3]
    module = twin(ctx.module, cfg, ctx.device)
    attn = module.get_submodule("layer0_cross_attn_m1").fn.train()
    b, t = mask.shape
    dt = module.dtype or torch.float32
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    x = torch.randn((b, cfg["num_latents"], cfg["latent_dim"]), generator=gen,
                    device=ctx.device).to(dt).requires_grad_(True)
    inner = cfg["cross_heads"] * cfg["cross_dim_head"]
    kv = torch.randn((b, t, 2 * inner), generator=gen, device=ctx.device).to(dt)
    kv.requires_grad_(True)
    seed = torch.tensor(12345, dtype=torch.int64, device=ctx.device)
    # to_kv is not on this call's path: the keys and values come precomputed
    leaves = [x, kv, attn.to_q.weight, attn.to_out.weight, attn.to_out.bias]
    with torch.no_grad():  # shapes only: an autograd graph kept here would pin its streams
        g = torch.randn_like(attn(x, kv=kv, kv_mask=mask, dropout_seed=seed)[0])

    def step():
        out = attn(x, kv=kv, kv_mask=mask, dropout_seed=seed)[0]
        torch.autograd.grad(out, leaves, g)

    return (step, *attention_cost(cfg, b, t))


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    step, flops, nbytes = work(ctx)
    return 100.0 * bound_s(flops, nbytes) / (graph_ms(step) / 1e3)
