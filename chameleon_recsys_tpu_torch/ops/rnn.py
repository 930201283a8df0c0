"""Recurrent layers (port of ``chameleon_recsys_tpu/ops/rnn.py``): the UGRNN
session encoder and the ACR text encoder's GRU and LSTM stacks.

UGRNN, the NAR session encoder, has the semantics of
``tf.contrib.rnn.UGRNNCell`` as the NAR uses it:
    g  = sigmoid(W_g.[x, h] + b_g + forget_bias)      (forget_bias = 1.0)
    c  = tanh   (W_c.[x, h] + b_c)
    h' = g*h + (1 - g)*c
The input projection of both gates is one [B, T, D] x [D, 2U] product outside
the recurrence; the recurrence carries only h . W_hh and the gate math.
Steps past a session's end copy h through, and the stacked outputs there are
zeroed.

GRU and LSTM, the ACR text encoder's (reference acr_model.py:308-399,
``CudnnGRU`` / ``CudnnLSTM``), run on ``torch.nn.GRU`` / ``torch.nn.LSTM``
(cuDNN on the card), whose cells are the JAX package's ``gru_scan`` (linear
before reset, gates r, z, n) and ``lstm_scan`` (gates i, f, g, o).  The JAX
LSTM adds ``forget_bias`` = 1.0 to the f gate at every step; here it lives
in ``bias_hh``'s f slice (``reset_parameters`` puts it there,
``convert.acr_params_from_flax`` adds it to the Flax recurrent bias).
Bidirectional stacks concatenate [fwd | bwd] per step and per final state,
and layer l + 1 reads 2U features, as in the JAX stacks.  Every step is
valid: the JAX stacks' all-ones mask, the only one the ACR models pass
(cuDNN ignores lengths there).  In training with ``keep_prob`` < 1 the
stacks drop out each layer's input past the first (``ops/dropout.py``; not
``nn.GRU``'s own dropout, which draws from the global generator), so they
run one cuDNN layer at a time; the autoencoder's decoder seeds each layer
with its own ``h0`` (unidirectional only, as in the JAX ``StackedGRU``).
In bfloat16 (``dtype``; the parameters stay float32 and are cast at each
use, as Flax's ``dtype=bf16, param_dtype=f32``) the same call runs on the
bf16 input and the bf16 copies of the weights, and carries its states
between steps in bf16, as the JAX ``lax.scan`` does.

``StackedUGRNN`` drops out every layer's output in training, the last
included, before the padded steps are zeroed (the reference's
``DropoutWrapper(output_keep_prob)`` on each cell).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .dropout import dropout
from .kernels.ugrnn import UGRNNScan, kernel_takes, ugrnn_scan_kernel


def ugrnn_scan(
    x_proj: torch.Tensor,  # [B, T, 2U] precomputed W_x.x + b
    w_hh: torch.Tensor,  # [U, 2U]
    mask: torch.Tensor,  # [B, T] bool validity
    forget_bias: float = 1.0,
) -> torch.Tensor:
    """UGRNN recurrence with zero h0 in x_proj's dtype (h is rounded to it
    every step)."""
    b, t, two_u = x_proj.shape
    units = two_u // 2
    h = x_proj.new_zeros((b, units))
    outs = []
    for step in range(t):
        acts = x_proj[:, step] + h @ w_hh
        c = torch.tanh(acts[:, units:])
        g = torch.sigmoid(acts[:, :units] + forget_bias)
        h_new = g * h + (1.0 - g) * c
        h = torch.where(mask[:, step, None], h_new, h)
        outs.append(h)
    if not outs:
        return x_proj.new_zeros((b, 0, units))
    return torch.stack(outs, dim=1)


class UGRNNLayer(nn.Module):
    """One UGRNN layer.  ``use_kernel`` runs the recurrence through the
    hand-written CUDA kernels (f32 state, as the TPU kernel keeps it): the
    forward alone with grad off, ``UGRNNScan`` (forward and backward
    kernels) with grad on.  Widths the kernels do not take
    (``kernel_takes``) run the plain scan."""

    def __init__(
        self,
        in_features: int,
        units: int,
        dtype: torch.dtype = torch.float32,
        use_kernel: bool = False,
    ):
        super().__init__()
        self.units = units
        self.forget_bias = 1.0  # UGRNNCell's default, which the NAR uses
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.input_proj = nn.Linear(in_features, 2 * units)
        self.recurrent_kernel = nn.Parameter(torch.empty(units, 2 * units))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x_proj = x.to(dt) @ self.input_proj.weight.to(dt).T + (
            self.input_proj.bias.to(dt)
        )
        w_hh = self.recurrent_kernel.to(dt)
        if self.use_kernel and kernel_takes(self.units, dt):
            operands = (x_proj.contiguous(), w_hh.contiguous(), mask)
            if torch.is_grad_enabled():
                return UGRNNScan.apply(*operands, self.forget_bias)
            return ugrnn_scan_kernel(*operands, self.forget_bias)
        return ugrnn_scan(x_proj, w_hh, mask, forget_bias=self.forget_bias)


class StackedUGRNN(nn.Module):
    """Stacked UGRNN; in training each layer's output is dropped out
    (``keep_prob`` < 1), then the outputs at padded steps are zeroed.  The
    kernel path's gradient arrives through the dropout masks."""

    def __init__(
        self,
        in_features: int,
        units: int,
        num_layers: int = 1,
        dtype: torch.dtype = torch.float32,
        use_kernel: bool = False,
        keep_prob: float = 1.0,
    ):
        super().__init__()
        self.keep_prob = keep_prob
        self.layers = nn.ModuleList(
            UGRNNLayer(
                in_features if i == 0 else units, units, dtype=dtype,
                use_kernel=use_kernel,
            )
            for i in range(num_layers)
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for layer in self.layers:
            h = layer(h, mask)
            if train:
                h = dropout(h, self.keep_prob, generator)
        return h * mask[..., None].to(h.dtype)


DIRECTIONS = ("unidirectional", "bidirectional")


class _CudnnStack(nn.Module):
    """A stack of ``cell`` layers (``nn.GRU`` or ``nn.LSTM``) with the JAX
    stacks' initialisation and final states."""

    gates = 0
    cell = None

    def __init__(self, in_features: int, units: int, num_layers: int = 1,
                 keep_prob: float = 1.0, direction: str = "unidirectional",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if direction not in DIRECTIONS:
            raise ValueError(f"invalid rnn direction {direction}")
        self.units = units
        self.keep_prob = keep_prob
        self.dtype = dtype
        self.bidirectional = direction == "bidirectional"
        self.rnn = self.cell(in_features, units, num_layers, batch_first=True,
                             bidirectional=self.bidirectional)

    @property
    def out_features(self) -> int:
        return self.units * (2 if self.bidirectional else 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's init of the JAX layers: glorot-uniform input and recurrent
        kernels, zero biases (the LSTM's forget bias in ``bias_hh``)."""
        with torch.no_grad():
            for name, param in self.rnn.named_parameters():
                if name.startswith("weight"):
                    fan_out, fan_in = param.shape  # [gates*U, in]: the Flax sum
                    limit = math.sqrt(6.0 / (fan_in + fan_out))
                    param.uniform_(-limit, limit, generator=generator)
                else:
                    param.zero_()
                    if name.startswith("bias_hh"):
                        param += self.forget_bias_vector().to(param)

    def forget_bias_vector(self) -> torch.Tensor:
        return torch.zeros(self.gates * self.units)

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, T, D], every step valid, and optionally each layer's initial
        state ``h0`` [layers, B, U] (unidirectional) -> (outputs [B, T, U or
        2U], final states [layers, B, U or 2U])."""
        if h0 is not None and self.bidirectional:
            raise ValueError("h0 seeding requires unidirectional direction")
        x = x.to(self.dtype)
        layers = self.rnn.num_layers
        if not train or self.keep_prob >= 1.0 or layers == 1:
            out, h_n = self._run(x, h0, 0, layers)
        else:
            out, finals = x, []
            for i in range(layers):
                if i > 0:
                    out = dropout(out, self.keep_prob, generator)
                out, h_i = self._run(out, None if h0 is None else h0[i: i + 1], i, 1)
                finals.append(h_i)
            h_n = torch.cat(finals)
        finals = h_n.view(-1, 2 if self.bidirectional else 1, x.shape[0], self.units)
        return out, torch.cat(finals.unbind(1), -1)

    def _run(self, x, h0, first: int, layers: int):
        """Layers ``first`` .. ``first + layers - 1`` of the stack on ``x``:
        (outputs, final hidden states [layers * dirs, B, U])."""
        if first == 0 and layers == self.rnn.num_layers and self.dtype == torch.float32:
            out, last = self.rnn(x, self._hx(h0, x))
            return out, last[0] if isinstance(last, tuple) else last
        # a slice of the stack, or bf16: torch's own entry point for one
        # nn.GRU / nn.LSTM call (what their forward calls), on that slice's
        # weights cast to the compute dtype
        per_layer = 4 * (2 if self.bidirectional else 1)
        weights = [w.to(self.dtype) for w in
                   self.rnn._flat_weights[first * per_layer:(first + layers) * per_layer]]
        hx = self._hx(h0, x, layers)
        if self.cell is nn.LSTM:
            out, h_n, _ = torch._VF.lstm(x, hx, weights, True, layers, 0.0,
                                         self.training, self.bidirectional, True)
        else:
            out, h_n = torch._VF.gru(x, hx, weights, True, layers, 0.0,
                                     self.training, self.bidirectional, True)
        return out, h_n

    def _hx(self, h0, x, layers: Optional[int] = None):
        """The cell's initial state: ``h0`` or zeros (and zero cells for an
        LSTM); None for the whole stack from zeros."""
        if h0 is None and layers is None:
            return None
        shape = ((layers or self.rnn.num_layers) * (2 if self.bidirectional else 1),
                 x.shape[0], self.units)
        h = x.new_zeros(shape) if h0 is None else h0.to(x.dtype).contiguous()
        return (h, torch.zeros_like(h)) if self.cell is nn.LSTM else h


class StackedGRU(_CudnnStack):
    """Stacked cuDNN-style GRU (the JAX ``StackedGRU``; gates r, z, n, linear
    before reset)."""

    gates = 3
    cell = nn.GRU


class StackedLSTM(_CudnnStack):
    """Stacked LSTM, cuDNN layout (the JAX ``StackedLSTM``; gates i, f, g, o,
    forget bias 1.0 on f, held in ``bias_hh``)."""

    gates = 4
    cell = nn.LSTM
    forget_bias = 1.0

    def forget_bias_vector(self) -> torch.Tensor:
        vector = torch.zeros(self.gates * self.units)
        vector[self.units: 2 * self.units] = self.forget_bias
        return vector
