"""Shared neural layers (counterpart of `escgnn_tpu/models/layers.py`).

Submodule and parameter names mirror the flax tree (`TorchDense_i`,
`MaskedBatchNorm_i`, `lin_edge`, `eps`) so `weights.py` can carry a flax
state across. Initialization follows torch defaults, drawn from an
explicit `torch.Generator` on the CPU: Linear = U(+-1/sqrt(fan_in)) for
kernel and bias, Embedding = N(0, 1).

Mixed precision follows JAX's promotion rules, written out as casts:
a bf16 activation times an f32 weight computes in f32 (`TorchDense`,
`(1 + eps) * x`), and BatchNorm returns its input dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from escgnn_tpu_torch.ops.embed import embed_take
from escgnn_tpu_torch.ops.segment import segment_sum


class TorchDense(nn.Linear):
    """nn.Linear with torch's default init drawn from `generator`; a
    lower-precision input is promoted to the f32 weight dtype."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, generator: torch.Generator):
        super().__init__(in_features, out_features, bias)
        bound = 1.0 / math.sqrt(in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if bias:
                self.bias.uniform_(-bound, bound, generator=generator)

    def reset_parameters(self):
        pass  # drawn in __init__ from the explicit generator

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class TorchEmbed(nn.Embedding):
    """nn.Embedding with N(0, 1) init drawn from `generator`."""

    def __init__(self, num_embeddings: int, features: int, *,
                 generator: torch.Generator):
        super().__init__(num_embeddings, features)
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def reset_parameters(self):
        pass  # drawn in __init__ from the explicit generator

    def forward(self, ids):
        return embed_take(self.weight, ids)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over rows with a validity mask or float row weights.

    Normalizes with the biased (weighted) batch variance in training and
    updates the running statistics with the unbiased variance, momentum
    0.1, eps 1e-5, affine. Float weights (row multiplicities) make BN
    over deduplicated rows equal BN over the expanded row set. Statistics
    and normalization run in f32; the output has the input's dtype.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        xf = x.to(torch.float32)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if mask is None:
                m = torch.ones((x.shape[0], 1), device=x.device)
            else:
                m = mask.to(torch.float32)[:, None]
            s1 = (xf * m).sum(0)
            s2 = (xf * xf * m).sum(0)
            n = m.sum().clamp_min(1.0)
            mean = s1 / n
            var = (s2 / n - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                mom = self.momentum
                self.running_mean.copy_(
                    (1 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_(
                    (1 - mom) * self.running_var + mom * unbiased)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class MLP(nn.Module):
    """The reference's Sequential pattern: [Linear -> BN -> act] per
    hidden layer; `pre_act=True` prepends BN -> act before the first
    Linear (the z_embedding head shape). Dropout is not ported (the
    flagship runs with dropout 0)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 act: Callable, pre_act: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.act = act
        self.order = []
        n_bn = 0
        if pre_act:
            self._add(f"MaskedBatchNorm_{n_bn}", MaskedBatchNorm(in_features))
            n_bn += 1
        d = in_features
        for i, f in enumerate(features):
            self._add(f"TorchDense_{i}", TorchDense(d, f, generator=generator))
            self._add(f"MaskedBatchNorm_{n_bn}", MaskedBatchNorm(f))
            n_bn += 1
            d = f

    def _add(self, name, module):
        self.add_module(name, module)
        self.order.append(name)

    def forward(self, x, mask=None):
        for name in self.order:
            layer = getattr(self, name)
            if isinstance(layer, MaskedBatchNorm):
                x = self.act(layer(x, mask))
            else:
                x = layer(x)
        return x


def _dense_local_aggregate(x, senders, receivers, edge_emb, edge_mask, n_u):
    """GINE aggregation on the uniform per-graph layout as per-graph
    one-hot einsums (graph g's edges only touch its own n_u node slots).
    Gather in the activation dtype, scatter with f32 accumulation, result
    in the activation dtype — JAX's promotions written out."""
    N, H = x.shape
    E = senders.shape[0]
    G = N // n_u
    e_u = E // G
    if G * n_u != N or G * e_u != E:
        raise ValueError(f"not a uniform block layout: {(N, E, n_u, e_u)}")
    cdt = x.dtype
    # one-hots by broadcast compare (F.one_hot would check the ids' range
    # with a device -> host copy)
    ar = torch.arange(n_u, device=senders.device)
    send_l = (senders.long() % n_u).reshape(G, e_u, 1)
    recv_l = (receivers.long() % n_u).reshape(G, e_u, 1)
    oh_s = (send_l == ar).to(cdt)
    gathered = torch.einsum("gen,gnh->geh", oh_s, x.reshape(G, n_u, H))
    msg = F.relu(gathered + edge_emb.reshape(G, e_u, -1))
    oh_r = (recv_l == ar).to(cdt) * edge_mask.reshape(G, e_u, 1).to(cdt)
    acc = torch.promote_types(msg.dtype, torch.float32)
    agg = torch.einsum("gen,geh->gnh", oh_r.to(acc), msg.to(acc))
    return agg.reshape(N, H).to(cdt)


class GINEConv(nn.Module):
    """PyG-semantics GINEConv with `train_eps=True` and an
    `edge_dim -> in_channels` projection:
        out = mlp((1 + eps) * x + sum_{(j->i)} relu(x_j + lin(e_ji)))
    On the uniform per-graph layout (`uniform_nodes`, the batch's
    `nodes_per_graph`) the aggregation is the per-graph one-hot einsum,
    else a masked segment sum."""

    def __init__(self, in_channels: int, mlp: MLP,
                 edge_dim: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.mlp = mlp
        self.eps = nn.Parameter(torch.zeros(()))
        self.lin_edge = (
            TorchDense(edge_dim, in_channels, generator=generator)
            if edge_dim is not None else None
        )

    def forward(self, x, senders, receivers, edge_emb, edge_mask,
                node_mask=None, uniform_nodes: Optional[int] = None):
        if self.lin_edge is not None:
            edge_emb = self.lin_edge(edge_emb)
        if uniform_nodes is not None:
            agg = _dense_local_aggregate(
                x, senders, receivers, edge_emb, edge_mask, uniform_nodes
            )
        else:
            dt = torch.promote_types(x.dtype, edge_emb.dtype)
            msg = F.relu(x.index_select(0, senders.long()).to(dt)
                         + edge_emb.to(dt))
            agg = segment_sum(msg, receivers, x.shape[0], edge_mask)
        dt = torch.promote_types(
            torch.promote_types(x.dtype, agg.dtype), self.eps.dtype)
        out = (1.0 + self.eps) * x.to(dt) + agg.to(dt)
        return self.mlp(out, node_mask)
