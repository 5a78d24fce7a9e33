"""Shared neural layers (counterpart of `escgnn_tpu/models/layers.py`).

Submodule and parameter names mirror the flax tree (`TorchDense_i`,
`MaskedBatchNorm_i`, `lin_edge`, `eps`) so `weights.py` can carry a flax
state across. Initialization follows torch defaults, drawn from an
explicit `torch.Generator` on the CPU: Linear = U(+-1/sqrt(fan_in)) for
kernel and bias, Embedding = N(0, 1).

Mixed precision follows JAX's promotion rules, written out as casts:
a bf16 activation times an f32 weight computes in f32 (`TorchDense`,
`(1 + eps) * x`), and BatchNorm returns its input dtype.

Dropout is flax's `nn.Dropout`: active only in `train()` (JAX's
`deterministic=False`), keep each entry with probability 1 - rate and
scale it by 1 / (1 - rate). Its uniform draws come from an explicit
`torch.Generator` that the model owns, on the model's device; JAX's
random bits are not reproduced, so tests compare it in eval mode and
check its statistics.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from escgnn_tpu_torch.ops.embed import embed_take
from escgnn_tpu_torch.ops.segment import gather_rows, segment_sum


def torch_linear_kernel_init(generator: torch.Generator, shape,
                             dtype=torch.float32):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch nn.Linear's default, for
    a kernel in flax's (fan_in, ...) layout, drawn from `generator`."""
    bound = 1.0 / math.sqrt(shape[0])
    return torch.empty(tuple(shape), dtype=dtype).uniform_(
        -bound, bound, generator=generator)


def torch_linear_bias_init(fan_in: int):
    """The bias init of nn.Linear for `fan_in` inputs: a function
    (generator, shape, dtype) -> U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    def init(generator: torch.Generator, shape, dtype=torch.float32):
        bound = 1.0 / math.sqrt(fan_in)
        return torch.empty(tuple(shape), dtype=dtype).uniform_(
            -bound, bound, generator=generator)

    return init


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


class EmbedMM(TorchEmbed):
    """The JAX package's `EmbedMM` (flax param path `embedding`, N(0, 1)
    init), whose lookup there is a one-hot matmul so that its backward
    runs on the MXU. Here it is `embed_take`: the same values, and its
    backward sums the output gradients per id in a fixed order, as the
    one-hot product's transpose does."""


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over rows with a validity mask or float row weights.

    Its statistics mode is its own flag, `use_running_average` (flax's
    argument of that name), not `nn.Module.training`: False normalizes
    with the biased (weighted) batch variance and updates the running
    statistics with the unbiased variance, momentum 0.1, eps 1e-5,
    affine; True normalizes with the running statistics. `train(mode)`
    sets the flag to `not mode`, as a default; `set_use_running_average`
    and `bn_statistics` set it on every BN of a model whatever its
    `training` (a batch-statistics pass in `eval()`, as JAX runs the BN
    refresh with `deterministic=True`). Float weights (row
    multiplicities) make BN over deduplicated rows equal BN over the
    expanded row set. Statistics and normalization run in f32; the output
    has the input's dtype. The batch statistics take two passes: the
    mean, then the sums of the rows centred about it (JAX sums x and x^2
    in one pass), so a column of equal rows normalizes to 0 on every
    device.

    `axis` (JAX's `axis_name`): the rows are split over the ranks of this
    mesh axis (a name or a tuple of names, `parallel/mesh.py`), so the
    batch statistics' sums (the rows' sum and count, then the centred
    rows' sums) are summed over them and every rank normalizes with the
    global statistics.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.use_running_average = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def train(self, mode: bool = True):
        super().train(mode)
        self.use_running_average = not mode
        return self

    def forward(self, x, mask: Optional[torch.Tensor] = None, axis=None):
        xf = x.to(torch.float32)
        if self.use_running_average:
            y = ((xf - self.running_mean)
                 * torch.rsqrt(self.running_var + self.eps))
        else:
            if mask is None:
                m = torch.ones((x.shape[0], 1), device=x.device)
            else:
                m = mask.to(torch.float32)[:, None]
            s1 = (xf * m).sum(0)
            n = m.sum()
            if axis is not None:
                tot = _psum(torch.cat([s1, n.reshape(1)]), axis)
                s1, n = tot[:-1], tot[-1]
            n = n.clamp_min(1.0)
            # centred about the first pass's mean, a constant (the result
            # does not depend on it): a column whose rows are equal
            # normalizes to 0, not to its mean's rounding error over
            # sqrt(eps), which the order of the sums sets
            shift = (s1 / n).detach()
            xf = xf - shift
            d1 = (xf * m).sum(0)
            d2 = (xf * xf * m).sum(0)
            if axis is not None:
                f = d1.shape[0]
                tot = _psum(torch.cat([d1, d2]), axis)
                d1, d2 = tot[:f], tot[f:]
            dmean = d1 / n
            xf = xf - dmean
            mean = shift + dmean
            var = (d2 / n - dmean * dmean).clamp_min(0.0)
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                mom = self.momentum
                self.running_mean.copy_(
                    (1 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_(
                    (1 - mom) * self.running_var + mom * unbiased)
            y = xf * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def _psum(x, axis):
    from escgnn_tpu_torch.parallel.mesh import psum

    return psum(x, axis)


def set_use_running_average(model: nn.Module, flag: bool) -> list:
    """Set the statistics mode of every `MaskedBatchNorm` in `model`,
    leaving `model.training` as it is; returns the previous modes, in
    `model.modules()` order."""
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    prev = [m.use_running_average for m in bns]
    for m in bns:
        m.use_running_average = flag
    return prev


@contextlib.contextmanager
def bn_statistics(model: nn.Module, use_running_average: bool):
    """Every BN of `model` in one statistics mode inside the block; each
    BN's own mode is put back on exit."""
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    prev = set_use_running_average(model, use_running_average)
    try:
        yield
    finally:
        for m, flag in zip(bns, prev):
            m.use_running_average = flag


def dropout(x, rate: float, rng: Optional[torch.Generator],
            training: bool):
    """flax `nn.Dropout(rate, deterministic=not training)(x)`: x where
    rate is 0 or not training, zeros where rate is 1, else each entry
    kept (uniform draw < 1 - rate, from `rng`) as x / (1 - rate), or 0."""
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=rng, device=x.device)
    return torch.where(u < keep, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """`dropout` as a module: draws from `rng` in `train()` only."""

    def __init__(self, rate: float, rng: Optional[torch.Generator]):
        super().__init__()
        if rate > 0.0 and rng is None:
            raise ValueError("dropout > 0 needs the model's generator")
        self.rate = float(rate)
        self.rng = rng

    def forward(self, x):
        return dropout(x, self.rate, self.rng, self.training)


class MLP(nn.Module):
    """The reference's Sequential pattern: [Linear -> Dropout -> BN ->
    act] per hidden layer; `pre_act=True` prepends Dropout -> BN -> act
    before the first Linear (the z_embedding head shape). Dropout draws
    from `rng` (needed when `dropout` > 0). `axis` in the call is the
    mesh axis the rows are split over: every BN sums its statistics over
    it."""

    def __init__(self, in_features: int, features: Sequence[int],
                 act: Callable, pre_act: bool = False, dropout: float = 0.0,
                 rng: Optional[torch.Generator] = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.act = act
        self.drop = Dropout(dropout, rng)
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

    def forward(self, x, mask=None, axis=None):
        for name in self.order:
            layer = getattr(self, name)
            if isinstance(layer, MaskedBatchNorm):
                x = self.act(layer(self.drop(x), mask, axis))
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


def _dense_local_scatter(msg, receivers, edge_mask, n_u, num_nodes):
    """Scatter-add per-edge messages to nodes on the uniform block layout
    as one batched one-hot product (the scatter half of
    `_dense_local_aggregate`, for a conv whose gather side is
    irregular); sums in f32, result in the messages' dtype."""
    E, H = msg.shape
    G = num_nodes // n_u
    e_u = E // G
    if G * n_u != num_nodes or G * e_u != E:
        raise ValueError(f"not a uniform block layout: {(num_nodes, E, n_u)}")
    ar = torch.arange(n_u, device=receivers.device)
    recv_l = (receivers.long() % n_u).reshape(G, e_u, 1)
    oh_r = (recv_l == ar).to(msg.dtype) * edge_mask.reshape(G, e_u, 1).to(
        msg.dtype)
    acc = torch.promote_types(msg.dtype, torch.float32)
    agg = torch.einsum("gen,geh->gnh", oh_r.to(acc),
                       msg.reshape(G, e_u, H).to(acc))
    return agg.reshape(num_nodes, H).to(msg.dtype)


def _dense_local_aggregate_regions(x, senders, receivers, edge_emb,
                                   edge_mask, regions):
    """`_dense_local_aggregate` over the two-size bucketed copy layout
    (`GraphBatch.seg_regions`): the node and edge arrays are [small region
    | large region], each a uniform block layout of its own, so the same
    batched products run once per region."""
    (cs, n_s, e_s), (cl, n_l, e_l) = regions
    outs = []
    n_off = e_off = 0
    for c, n_u, e_u in ((cs, n_s, e_s), (cl, n_l, e_l)):
        if c == 0:
            continue
        ne, ee = c * n_u, c * e_u
        outs.append(_dense_local_aggregate(
            x[n_off:n_off + ne],
            senders[e_off:e_off + ee] - n_off,
            receivers[e_off:e_off + ee] - n_off,
            edge_emb[e_off:e_off + ee],
            edge_mask[e_off:e_off + ee],
            n_u,
        ))
        n_off += ne
        e_off += ee
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


class GINEConv(nn.Module):
    """PyG-semantics GINEConv with `train_eps=True` and an
    `edge_dim -> in_channels` projection:
        out = mlp((1 + eps) * x + sum_{(j->i)} relu(x_j + lin(e_ji)))
    On the uniform per-graph layout (`uniform_nodes`, the batch's
    `nodes_per_graph`) the aggregation is the per-graph one-hot einsum,
    else a masked segment sum.

    Sharded execution (`parallel/`), chosen in the call:
      * `edge_shard_axis`: this rank holds a slice of the edges and all
        the nodes it touches; the local segment sum is summed over the
        axis (the uniform one-hot path is bypassed);
      * `halo` = (axis, boundary_send, halo_src): receiver-range node and
        edge shards (`parallel/halo.py`); x holds this rank's node rows,
        the remote sender rows arrive by one boundary exchange, and the
        segment sum stays local;
      * `axis`: the mesh axis the node rows are split over, for the MLP's
        BatchNorms."""

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
                node_mask=None, uniform_nodes: Optional[int] = None, *,
                edge_shard_axis=None, halo: Optional[tuple] = None,
                axis=None):
        if self.lin_edge is not None:
            edge_emb = self.lin_edge(edge_emb)
        if (uniform_nodes is not None and edge_shard_axis is None
                and halo is None):
            agg = _dense_local_aggregate(
                x, senders, receivers, edge_emb, edge_mask, uniform_nodes
            )
        else:
            src = x
            if halo is not None:
                from escgnn_tpu_torch.parallel.halo import halo_exchange

                halo_axis, boundary_send, halo_src = halo
                src = torch.cat(
                    [x, halo_exchange(x, boundary_send, halo_src, halo_axis)])
            dt = torch.promote_types(x.dtype, edge_emb.dtype)
            msg = F.relu(gather_rows(src, senders).to(dt)
                         + edge_emb.to(dt))
            agg = segment_sum(msg, receivers, x.shape[0], edge_mask)
        if edge_shard_axis is not None:
            from escgnn_tpu_torch.parallel.mesh import psum

            agg = psum(agg, edge_shard_axis)
        dt = torch.promote_types(
            torch.promote_types(x.dtype, agg.dtype), self.eps.dtype)
        out = (1.0 + self.eps) * x.to(dt) + agg.to(dt)
        return self.mlp(out, node_mask, axis)
