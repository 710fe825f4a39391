"""MultiModN: sequential modular multimodal network with state passing.

Counterpart of ``healnet_tpu/models/baselines/multimodn.py``:

- :class:`MultiModNModule`: a trainable initial ``state`` broadcast over the
  batch; each modality's encoder updates the state in turn; after every
  encoder every decoder predicts and incurs a cross-entropy loss, plus one
  state-change penalty per encoder; the losses are averaged over encoders.
  Decoders also predict from the initial state (stage 0) with
  ``return_stages``;
- encoders: :class:`MLPEncoder` (an MLP whose last layer sees
  ``[features, state]``), :class:`PatchEncoder` (a stack of GRU layers,
  the activation between them, then the sum over tokens and a Linear over
  ``[sum, state]``), :class:`ResNetEncoder` (a small residual conv
  encoder for raw images);
- decoders: :class:`ClassDecoder`, :class:`MLPDecoder`,
  :class:`LogisticDecoder`;
- :func:`_softmax_ce` and :class:`MultiModNHistory` (its table a
  :class:`~healnet_tpu_torch.etl.table.Table`, its CSV written with
  :mod:`csv`: no pandas).

As in JAX, :class:`ClassDecoder` applies its activation (a sigmoid by
default), so a survival loss on its outputs takes them as logits, and
:class:`PatchEncoder` runs over the tokens as it gets them (zero-padded
tokens included).

Each GRU layer is Flax's ``GRUCell`` scanned over the tokens from a zero
carry (``nn.RNN``): r and z from ``ir + hr`` and ``iz + hz``, n = tanh(in
+ r * hn), ``hr`` and ``hz`` without bias. That is torch's GRU with the
recurrent biases of r and z held at zero and gates ordered (r, z, n), so
each layer runs as one single-layer cuDNN GRU (``torch._VF.gru``) on its
weights stacked at each call, parameters kept under Flax's names.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.etl.table import Table, csv_cell
from healnet_tpu_torch.models.baselines.common import (
    Block,
    Conv,
    LecunDense,
    OrthogonalDense,
)
from healnet_tpu_torch.models.layers import torch_dense


# ------------------------------------------------------------------ encoders

class MLPEncoder(Block):
    """MLP encoder (``fc_{i}``); the state joins the final layer's input
    (``fc_out``). ``input_shape``: the per-sample shape of its tensor."""

    def __init__(self, state_size: int, hidden_layers: Sequence[int] = (128, 64),
                 activation: Callable = F.relu, *, input_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.state_size, self.activation = state_size, activation
        self.hidden_layers = tuple(hidden_layers)
        width = math.prod(input_shape)
        for i, features in enumerate(self.hidden_layers):
            self.add_module(f"fc_{i}", torch_dense(features, width))
            width = features
        self.fc_out = torch_dense(state_size, width + state_size)
        self.reset_parameters(generator)

    def forward(self, state: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1)
        for i in range(len(self.hidden_layers)):
            h = self.activation(getattr(self, f"fc_{i}")(h))
        return self.fc_out(torch.cat([h, state], dim=-1))


class GRULayer(nn.Module):
    """One Flax ``nn.RNN(GRUCell(features))`` over ``(b, tokens, in)``,
    returning every step's output; submodules ``ir``, ``iz``, ``in``
    (lecun-normal, with bias), ``hr``, ``hz`` (orthogonal, no bias) and
    ``hn`` (orthogonal, with bias)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        for name in ("ir", "iz", "in"):
            self.add_module(name, LecunDense(in_features, features))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            self.add_module(name, OrthogonalDense(features, features, use_bias=bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = dict(self.named_children())
        w_ih = torch.cat([m["ir"].weight, m["iz"].weight, m["in"].weight])
        w_hh = torch.cat([m["hr"].weight, m["hz"].weight, m["hn"].weight])
        b_ih = torch.cat([m["ir"].bias, m["iz"].bias, m["in"].bias])
        b_hh = torch.cat([torch.zeros_like(m["hn"].bias).repeat(2), m["hn"].bias])
        x = x.to(torch.promote_types(x.dtype, w_ih.dtype))  # Flax's promotion
        h0 = x.new_zeros(1, x.shape[0], self.features)
        out, _ = torch._VF.gru(x, h0, (w_ih, w_hh, b_ih, b_hh), True, 1, 0.0,
                               self.training, False, True)
        return out


class PatchEncoder(Block):
    """Recurrent encoder over patch bags ``(b, tokens, feat)``: GRU layers
    ``rnn_{i}`` with the activation after each, the sum over tokens, then
    ``fc_out`` over ``[sum, state]``."""

    def __init__(self, state_size: int, hidden_layers: Sequence[int] = (128, 64),
                 activation: Callable = F.relu, *, input_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.state_size, self.activation = state_size, activation
        self.hidden_layers = tuple(hidden_layers)
        width = input_shape[-1]
        for i, features in enumerate(self.hidden_layers):
            self.add_module(f"rnn_{i}", GRULayer(width, features))
            width = features
        self.fc_out = torch_dense(state_size, width + state_size)
        self.reset_parameters(generator)

    def forward(self, state: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(len(self.hidden_layers)):
            h = self.activation(getattr(self, f"rnn_{i}")(h))
        return self.fc_out(torch.cat([torch.sum(h, dim=1), state], dim=-1))


class ResNetEncoder(Block):
    """Small residual conv encoder for raw images ``(b, h, w, c)``: ``stem``
    (7x7, stride 2), then per width ``down_{i}`` (3x3, stride 2) and a
    residual pair ``conv_{i}a`` / ``conv_{i}b``; the spatial mean joins the
    state in ``fc``."""

    def __init__(self, state_size: int, widths: Sequence[int] = (32, 64, 128), *,
                 input_shape: Sequence[int], generator: Optional[torch.Generator] = None):
        super().__init__()
        self.state_size, self.widths = state_size, tuple(widths)
        self.stem = Conv(input_shape[-1], self.widths[0], (7, 7), (2, 2))
        prev = self.widths[0]
        for i, width in enumerate(self.widths):
            self.add_module(f"down_{i}", Conv(prev, width, (3, 3), (2, 2)))
            self.add_module(f"conv_{i}a", Conv(width, width, (3, 3)))
            self.add_module(f"conv_{i}b", Conv(width, width, (3, 3)))
            prev = width
        self.fc = torch_dense(state_size, prev + state_size)
        self.reset_parameters(generator)

    def forward(self, state: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.stem(x))
        for i in range(len(self.widths)):
            res = getattr(self, f"down_{i}")(h)
            block = F.relu(getattr(self, f"conv_{i}a")(res))
            block = getattr(self, f"conv_{i}b")(block)
            h = F.relu(res + block)
        return self.fc(torch.cat([torch.mean(h, dim=(1, 2)), state], dim=-1))


# ------------------------------------------------------------------ decoders

class ClassDecoder(Block):
    """Task head over the state: ``activation(fc(state))``."""

    def __init__(self, n_classes: int, activation: Callable = torch.sigmoid, *,
                 state_size: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_classes, self.activation = n_classes, activation
        self.fc = torch_dense(n_classes, state_size)
        self.reset_parameters(generator)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        return self.activation(self.fc(state))


class MLPDecoder(Block):
    """MLP task head: ``fc_{i}`` with the hidden activation, then ``fc_out``
    with the output activation."""

    def __init__(self, hidden_layers: Sequence[int] = (64,), n_classes: int = 2,
                 hidden_activation: Callable = F.relu,
                 output_activation: Callable = torch.sigmoid, *, state_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_layers, self.n_classes = tuple(hidden_layers), n_classes
        self.hidden_activation, self.output_activation = hidden_activation, output_activation
        width = state_size
        for i, features in enumerate(self.hidden_layers):
            self.add_module(f"fc_{i}", torch_dense(features, width))
            width = features
        self.fc_out = torch_dense(n_classes, width)
        self.reset_parameters(generator)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        h = state
        for i in range(len(self.hidden_layers)):
            h = self.hidden_activation(getattr(self, f"fc_{i}")(h))
        return self.output_activation(self.fc_out(h))


class LogisticDecoder(ClassDecoder):
    """Binary logistic head."""

    def __init__(self, n_classes: int = 2, activation: Callable = torch.sigmoid, *,
                 state_size: int, generator: Optional[torch.Generator] = None):
        super().__init__(n_classes, activation, state_size=state_size, generator=generator)


# ------------------------------------------------------------------- module

class MultiModNModule(Block):
    """Sequential encoder-state network with per-step decoder losses.

    ``forward(tensors, targets_onehot)`` returns ``(loss, logits)``; without
    targets, the final logits. ``return_stages`` returns ``(stages,
    state_changes, loss or None)``: every stage's decoder outputs (stage 0
    from the initial state), the mean squared state change of each
    encoder. ``presence[:, i]`` 0 keeps the state through encoder ``i``;
    ``sample_weights`` (0 on padded rows) leaves rows out of the losses.
    Submodules are named ``encoders_{i}`` / ``decoders_{j}`` (Flax's names
    of list members), the initial state ``state`` (N(0, 1)).
    """

    def __init__(self, state_size: int, encoders: Sequence[nn.Module],
                 decoders: Sequence[nn.Module], err_penalty: float = 1.0,
                 state_change_penalty: float = 0.0, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.state_size = state_size
        self.err_penalty, self.state_change_penalty = err_penalty, state_change_penalty
        self.state = nn.Parameter(torch.empty(state_size))
        for i, enc in enumerate(encoders):
            self.add_module(f"encoders_{i}", enc)
        for j, dec in enumerate(decoders):
            self.add_module(f"decoders_{j}", dec)
        self.n_encoders, self.n_decoders = len(encoders), len(decoders)
        self.reset_parameters(generator)
        self.to(device)

    @property
    def encoders(self) -> List[nn.Module]:
        return [getattr(self, f"encoders_{i}") for i in range(self.n_encoders)]

    @property
    def decoders(self) -> List[nn.Module]:
        return [getattr(self, f"decoders_{j}") for j in range(self.n_decoders)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.state.normal_(0.0, 1.0, generator=generator)
        super().reset_parameters(generator)

    def forward(self, tensors, targets: Optional[torch.Tensor] = None,
                presence: Optional[torch.Tensor] = None, return_stages: bool = False,
                sample_weights: Optional[torch.Tensor] = None):
        if len(tensors) != self.n_encoders:
            raise ValueError("Number of inputs must match number of encoders")
        b = tensors[0].shape[0]
        state = self.state.expand(b, self.state_size)
        stages = [[dec(state) for dec in self.decoders]] if return_stages else []
        state_changes = []
        running_loss = 0.0
        logits = None
        for i, (encoder, x) in enumerate(zip(self.encoders, tensors)):
            old_state = state
            state = encoder(state, x)
            if presence is not None:
                pres = presence[:, i][:, None].to(state.dtype)
                state = pres * state + (1.0 - pres) * old_state
            state_changes.append(torch.mean((state - old_state) ** 2))
            stage_logits = []
            for decoder in self.decoders:
                logits = decoder(state)
                stage_logits.append(logits)
                if targets is not None:
                    running_loss = running_loss + _softmax_ce(
                        logits, targets, sample_weights) * self.err_penalty
            if targets is not None:
                # one state-change penalty per encoder step
                running_loss = running_loss + state_changes[-1] * self.state_change_penalty
            if return_stages:
                stages.append(stage_logits)
        if return_stages:
            loss = running_loss / self.n_encoders if targets is not None else None
            return stages, torch.stack(state_changes), loss
        if targets is None:
            return logits
        return running_loss / self.n_encoders, logits


def _softmax_ce(logits: torch.Tensor, targets_onehot: torch.Tensor,
                sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``nn.CrossEntropyLoss`` with soft targets; ``sample_weights``
    (a 0/1 padding mask) leaves padded rows out of the mean."""
    per_row = -torch.sum(targets_onehot * F.log_softmax(logits, dim=-1), dim=-1)
    if sample_weights is None:
        return torch.mean(per_row)
    w = sample_weights.to(per_row.dtype)
    return torch.sum(per_row * w) / torch.clamp(torch.sum(w), min=1.0)


class MultiModNHistory:
    """Per-encoder x decoder metric history, written as CSV."""

    def __init__(self):
        self._records: List[Dict[str, Union[int, float]]] = []

    def log(self, epoch: int, encoder: int, decoder: int, **metrics) -> None:
        rec = {"epoch": epoch, "encoder": encoder, "decoder": decoder}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._records.append(rec)

    def to_dataframe(self) -> Table:
        """The records as a :class:`Table`: one column per key in order of
        first appearance, NaN where a record lacks it (as pandas'
        ``DataFrame`` of the records)."""
        keys = list(dict.fromkeys(k for rec in self._records for k in rec))
        columns = {}
        for key in keys:
            values = [rec.get(key, np.nan) for rec in self._records]
            ints = all(isinstance(v, int) for v in values)
            columns[key] = np.asarray(values, np.int64 if ints else np.float64)
        return Table(columns)

    def save_csv(self, path) -> None:
        """The table as CSV without the index (``to_csv(index=False)``)."""
        table = self.to_dataframe()
        with open(Path(path), "w", newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")
            writer.writerow(table.columns)
            for i in range(len(table)):
                writer.writerow([csv_cell(table[c][i]) for c in table.columns])

    def plot(self, metric: str, path=None):  # pragma: no cover - viz helper
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        table = self.to_dataframe()
        fig, ax = plt.subplots()
        for enc, dec in sorted(set(zip(table["encoder"].tolist(), table["decoder"].tolist()))):
            rows = (table["encoder"] == enc) & (table["decoder"] == dec)
            ax.plot(table["epoch"][rows], table[metric][rows], label=f"enc{enc}/dec{dec}")
        ax.set_xlabel("epoch")
        ax.set_ylabel(metric)
        ax.legend()
        if path is not None:
            fig.savefig(path)
        return fig
