"""kv_projection_roofline.train (%, kernels): the bound of the model's
context projections of a batch at the widest bucket, forward and weight
backward (``portbench/counts.py::projection_cost``), over their device time
through the model's own entry, ``HealNetModule.project_contexts`` and its
backward, captured in a graph and replayed (``portbench/timing.py``)."""

import torch

from healnet_tpu_torch.ops.quantize import QuantizedContext
from portbench.counts import bound_s, projection_cost
from portbench.program import twin
from portbench.timing import graph_ms


def work(ctx):
    """(one forward and backward, its operations, its bytes)."""
    module = twin(ctx.module, ctx.cfg, ctx.device).train()
    omic, values, scales, _ = ctx.cohort.gather(ctx.cohort.widest_batch())
    slide = QuantizedContext(values, scales)
    leaves = [p for n, p in module.named_parameters() if ".to_kv." in n or ".norm_context." in n]
    with torch.no_grad():  # shapes only: an autograd graph kept here would pin its streams
        grads = [torch.randn_like(kv) for kv in module.project_contexts([omic, slide])[0]]

    def step():
        out = module.project_contexts([omic, slide])[0]
        torch.autograd.grad(out, leaves, grads)

    return (step, *projection_cost(ctx.cfg, *slide.data.shape[:2]))


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    step, flops, nbytes = work(ctx)
    return 100.0 * bound_s(flops, nbytes) / (graph_ms(step) / 1e3)
