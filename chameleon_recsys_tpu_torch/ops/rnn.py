"""UGRNN session encoder (port of ``chameleon_recsys_tpu/ops/rnn.py``).

Semantics of ``tf.contrib.rnn.UGRNNCell`` as the NAR session encoder uses it:
    g  = sigmoid(W_g.[x, h] + b_g + forget_bias)      (forget_bias = 1.0)
    c  = tanh   (W_c.[x, h] + b_c)
    h' = g*h + (1 - g)*c
The input projection of both gates is one [B, T, D] x [D, 2U] product outside
the recurrence; the recurrence carries only h . W_hh and the gate math.
Steps past a session's end copy h through, and the stacked outputs there are
zeroed.
"""
from __future__ import annotations

import torch
from torch import nn

from .kernels.ugrnn import UGRNNScan, ugrnn_scan_kernel


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
    kernels) with grad on."""

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
        if self.use_kernel:
            operands = (x_proj.contiguous(), w_hh.contiguous(), mask)
            if torch.is_grad_enabled():
                return UGRNNScan.apply(*operands, self.forget_bias)
            return ugrnn_scan_kernel(*operands, self.forget_bias)
        return ugrnn_scan(x_proj, w_hh, mask, forget_bias=self.forget_bias)


class StackedUGRNN(nn.Module):
    """Stacked UGRNN; outputs at padded steps are zeroed.  The per-layer
    output dropout of training (``keep_prob < 1``) is not ported."""

    def __init__(
        self,
        in_features: int,
        units: int,
        num_layers: int = 1,
        dtype: torch.dtype = torch.float32,
        use_kernel: bool = False,
    ):
        super().__init__()
        self.layers = nn.ModuleList(
            UGRNNLayer(
                in_features if i == 0 else units, units, dtype=dtype,
                use_kernel=use_kernel,
            )
            for i in range(num_layers)
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.layers:
            h = layer(h, mask)
        return h * mask[..., None].to(h.dtype)
