"""The operation counts against ``torch.utils.flop_counter.FlopCounterMode``
over the plain reference, forward and backward, at a small size."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts
from portbench.reference.healnet import forward, nll_rows
from portbench.tests.tiny import tiny_files


def _params(cfg, gen):
    lc, ld, inner = cfg["num_latents"], cfg["latent_dim"], cfg["cross_heads"] * cfg["cross_dim_head"]
    e = counts.enc_dim(cfg)
    p = {"latents": torch.randn(lc, ld, generator=gen),
         "final_norm.weight": torch.ones(ld), "final_norm.bias": torch.zeros(ld),
         "final_head.weight": torch.randn(cfg["output_dims"], ld, generator=gen) * 0.1,
         "final_head.bias": torch.zeros(cfg["output_dims"])}
    for layer in range(cfg["depth"]):
        for m, c in enumerate((cfg["omic_dim"], cfg["wsi_dim"])):
            a, f = f"layer{layer}_cross_attn_m{m}.", f"layer{layer}_cross_ff_m{m}."
            p.update({a + "norm.weight": torch.ones(ld), a + "norm.bias": torch.zeros(ld),
                      a + "norm_context.weight": torch.ones(c + e),
                      a + "norm_context.bias": torch.zeros(c + e),
                      a + "fn.to_q.weight": torch.randn(inner, ld, generator=gen) * 0.1,
                      a + "fn.to_kv.weight": torch.randn(2 * inner, c + e, generator=gen) * 0.1,
                      a + "fn.to_out.weight": torch.randn(ld, inner, generator=gen) * 0.1,
                      a + "fn.to_out.bias": torch.zeros(ld),
                      f + "norm.weight": torch.ones(ld), f + "norm.bias": torch.zeros(ld),
                      f + "fn.net_0.weight": torch.randn(8 * ld, ld, generator=gen) * 0.1,
                      f + "fn.net_0.bias": torch.zeros(8 * ld),
                      f + "fn.net_2.weight": torch.randn(ld, 4 * ld, generator=gen) * 0.1,
                      f + "fn.net_2.bias": torch.zeros(ld)})
    return {k: v.requires_grad_(True) for k, v in p.items()}


@pytest.mark.parametrize("tokens", [16, 40])
@pytest.mark.parametrize("train", [True, False])
def test_flops_match_the_flop_counter(tokens, train):
    _, cfg, _, _ = tiny_files()
    gen = torch.Generator().manual_seed(tokens)
    b = 3
    p = _params(cfg, gen)
    omic = torch.randn(b, 1, cfg["omic_dim"], generator=gen)
    slide = torch.randn(b, tokens, cfg["wsi_dim"], generator=gen)
    mask = torch.ones(b, tokens, dtype=torch.bool)
    with FlopCounterMode(display=False) as counter:
        if train:
            logits = forward(p, cfg, omic, slide, mask, train=True, seeds=[1, 2, 3, 4],
                             ff_gen=torch.Generator().manual_seed(0))
            loss = nll_rows(logits, torch.zeros(b, dtype=torch.long), torch.zeros(b), None).mean()
            loss.backward()
        else:
            with torch.no_grad():
                forward(p, cfg, omic, slide, mask)
    want = (counts.train_flops if train else counts.eval_flops)(cfg, tokens) * b
    assert counter.get_total_flops() == pytest.approx(want, rel=1e-12)


def test_fold_flops_sums_samples():
    _, cfg, _, _ = tiny_files()
    lengths = np.array([16, 40, 64])
    got = counts.fold_flops(cfg, lengths, lengths[:1], epochs=5, eval_epochs=5)
    want = 5 * sum(counts.train_flops(cfg, n) for n in lengths) + 5 * counts.eval_flops(cfg, 16)
    assert got == pytest.approx(want)


def test_rooflines_are_bounded_by_their_work():
    _, cfg, _, _ = tiny_files()
    flops, nbytes = counts.projection_cost(cfg, 8, 64)
    assert flops == pytest.approx(2 * 8 * counts.projection_flops(cfg, 64))
    assert counts.bound_s(flops, nbytes) >= flops / counts.PEAK_FLOPS_BF16
    flops, nbytes = counts.attention_cost(cfg, 8, 64)
    assert counts.bound_s(flops, nbytes) >= nbytes / counts.PEAK_BYTES_PER_S
