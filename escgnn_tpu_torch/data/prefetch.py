"""Batch prefetching and device-resident batch pools (counterpart of
`escgnn_tpu/data/prefetch.py`).

  * `prefetched_batches`: the batches of `batch_iterator` (or of
    `packed_batch_iterator` with `packed=True`), built `depth` ahead on a
    background thread, which also issues their copies to the card from
    pinned host memory.
  * `materialized_batches`: a fixed split padded once, kept on the card
    when it is small; `materialized_batch_pools`: k of them, each over
    its own permutation of the graphs.
  * `stack_split` and `stacked_batch_pools`: padded batches stacked along
    a new leading pool axis on the card, one `GraphBatch` whose tensors
    carry that axis (fields that are None stay None). A pool step indexes
    them on the card (`train/loop.py`), so an epoch copies nothing from
    the host but its order vector. `stacked_batch_pools` draws the JAX
    package's permutations from the same seed, so both packages train on
    the same batch sequence. With `compress=True` the pools are stored
    losslessly downcast (`data/compress.py`) and come with the decoder
    the pool step applies on the card; `stack_split_compressed` does the
    same for a fixed split.

`batch_transform` (host batch -> host batch, a host batch being a
`GraphBatch` whose tensors lie on the CPU) applies to every batch before
it is stacked or copied to the card: the two-size bucketed copy layout
(`data/uniform_copies.py` `make_bucket_transform`), whose pinned region
budgets give every transformed batch one shape.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import (
    BatchSpec,
    batch_from_arrays,
    batch_iterator,
    packed_batch_iterator,
)
from escgnn_tpu_torch.data.container import GraphBatch, GraphData
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.utils import trace

_SENTINEL = object()


def prefetched_batches(
    graphs: Sequence[GraphData],
    spec: BatchSpec,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    device="cuda",
    packed: bool = False,
    depth: int = 2,
) -> Iterator[GraphBatch]:
    """Yield the batches of `batch_iterator(graphs, spec, shuffle, rng)`
    (`packed_batch_iterator` with `packed=True`) on `device`, built
    `depth` ahead on a background thread. On a CUDA device the thread
    copies each array through pinned memory without blocking; the copies
    are ordered before the consumer's work on the same (default) stream."""
    device = resolve_device(device)
    it_fn = packed_batch_iterator if packed else batch_iterator
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def produce():
        try:
            for arrays in it_fn(graphs, spec, shuffle=shuffle, rng=rng,
                                device=None):
                q.put(batch_from_arrays(arrays, spec, device, pin=True))
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    while True:
        b = q.get()
        if b is _SENTINEL:
            break
        yield b
    t.join()
    if err:
        raise err[0]


def _nbytes(batch: GraphBatch) -> int:
    return sum(t.nbytes for t in batch.tensors().values())


def _host_batches(graphs, spec: BatchSpec, batch_transform=None) -> list:
    """The padded batches of `graphs`, in order, as host batches, each
    through `batch_transform` when one is given."""
    out = [batch_from_arrays(a, spec, "cpu")
           for a in batch_iterator(graphs, spec, device=None)]
    return out if batch_transform is None else [batch_transform(b)
                                                for b in out]


def _upload(host: GraphBatch, device) -> GraphBatch:
    """`host` copied to `device` and waited for, under the `pools.upload`
    span (set-up only: the wait must stay off every step path)."""
    device = resolve_device(device)
    trace.count("pools.bytes", _nbytes(host))
    grid = (host.extras or {}).get("attn_bias")
    if grid is not None:  # GPS's stacked SPD grids, (..., G, M, M)
        trace.count("pools.attn_bias_bytes", grid.nbytes)
    with trace.span("pools.upload"):
        out = host.to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return out


def stack_batches(batches: list) -> GraphBatch:
    """Batches of one shape stacked along a new leading pool axis, on
    their device."""
    first = batches[0]
    return first.with_tensors({
        k: torch.stack([b.tensors()[k] for b in batches])
        for k in first.tensors()})


class _CachedBatches:
    """Padded batches of a fixed split: on the card when they fit in
    `pin_bytes`, else kept on the host and copied through pinned memory
    on each access."""

    def __init__(self, host: list, device, pin: bool):
        self._device = device
        self._pin = pin
        self._batches = [b.to(device) for b in host] if pin else host

    def __len__(self):
        return len(self._batches)

    def __getitem__(self, i) -> GraphBatch:
        b = self._batches[i]
        if self._pin or self._device.type != "cuda":
            return b.to(self._device)
        return b.with_tensors({
            k: v.pin_memory().to(self._device, non_blocking=True)
            for k, v in b.tensors().items()})

    def __iter__(self):
        for i in range(len(self._batches)):
            yield self[i]


def materialized_batches(graphs: Sequence[GraphData], spec: BatchSpec,
                         device="cuda", pin_bytes: int = 256 * 2**20,
                         batch_transform=None):
    """Pad a fixed set of graphs once and return a reusable sequence of
    batches: evaluation sets never reshuffle, so padding them every epoch
    only burns host time."""
    device = resolve_device(device)
    host = _host_batches(graphs, spec, batch_transform)
    total = sum(_nbytes(b) for b in host)
    return _CachedBatches(host, device, pin=total <= pin_bytes)


def materialized_batch_pools(graphs: Sequence[GraphData], spec: BatchSpec,
                             k: int = 4, seed: int = 0,
                             pin_bytes: int = 256 * 2**20, device="cuda"
                             ) -> list:
    """`k` `materialized_batches` of the same graphs, pool i padded in
    the order of the i-th `np.random.default_rng(seed).permutation` (the
    JAX package's draws). Cycling them across epochs stands in for
    re-forming batches every epoch at k paddings in all; k = 1 is a
    fixed pool."""
    rng = np.random.default_rng(seed)
    return [materialized_batches(
        [graphs[int(i)] for i in rng.permutation(len(graphs))], spec,
        device=device, pin_bytes=pin_bytes) for _ in range(max(1, k))]


def stack_split(graphs: Sequence[GraphData], spec: BatchSpec,
                device="cuda", batch_transform=None) -> GraphBatch:
    """Pad a fixed split once and stack its batches along a new leading
    axis on `device`: each eval or refresh pass over it then reads the
    card only. Every transformed batch must have one shape."""
    with trace.span("pools.pad"):
        host = stack_batches(_host_batches(graphs, spec, batch_transform))
    return _upload(host, device)


def pool_size(stacked: GraphBatch) -> int:
    return stacked.graph_mask.shape[0]


def pool_entry(stacked: GraphBatch, i: int) -> GraphBatch:
    """Batch `i` of a stacked pool (views, no copy)."""
    return stacked.with_tensors(
        {k: v[i] for k, v in stacked.tensors().items()})


def stack_split_compressed(graphs: Sequence[GraphData], spec: BatchSpec,
                           device="cuda", batch_transform=None) -> tuple:
    """`stack_split` with lossless downcasting (`data/compress.py`):
    returns the stack on `device` and its decoder, for eval splits that
    would otherwise hold f32 stacks on the card beside a compressed train
    pool."""
    from escgnn_tpu_torch.data.compress import compress_tree, make_decoder

    with trace.span("pools.pad"):
        host, metas = compress_tree(
            stack_batches(_host_batches(graphs, spec, batch_transform)))
    return _upload(host, device), make_decoder(metas)


def _identity(batch: GraphBatch) -> GraphBatch:
    return batch


def stacked_batch_pools(
    graphs: Sequence[GraphData],
    spec: BatchSpec,
    k: int = 4,
    seed: int = 0,
    max_total_bytes: int = 4 * 2**30,
    compress: bool = False,
    device="cuda",
    batch_transform=None,
) -> tuple:
    """`k` membership-shuffled stacked train pools on `device`, the
    number of batches per epoch, and the pools' decoder.

    Pool i holds the whole train split, padded in the order of the i-th
    `np.random.default_rng(seed).permutation` (the JAX package's draws).
    Cycling pools across epochs (pool (epoch-1) % k, its batches in a
    fresh order each epoch) stands in for re-forming batches every epoch
    at a bounded copy cost. All pools live on the card at once, so k is
    cut to keep them under `max_total_bytes`, counted in the bytes the
    pools take there. `batch_transform` (the bucketed copy layout, pinned
    budgets) applies to every batch of every pool, so all pools keep one
    shape.

    `compress=True` stores the pools losslessly downcast
    (`data/compress.py`; pools after the first take the first one's
    dtypes) and returns the decoder the pool step must apply to each
    batch; with `compress=False` the decoder is the identity."""
    from escgnn_tpu_torch.data.compress import (
        compress_tree,
        compress_tree_like,
        make_decoder,
    )

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    pools: list = []
    decode = _identity
    first = None
    kk = max(1, k)
    while len(pools) < kk:
        with trace.span("pools.pad"):
            shuffled = [graphs[int(j)] for j in rng.permutation(len(graphs))]
            host = stack_batches(_host_batches(shuffled, spec,
                                               batch_transform))
            if compress:
                if first is None:
                    host, metas = compress_tree(host)
                    decode = make_decoder(metas)
                    first = host
                else:
                    # one decoder and one captured step for every pool
                    host = compress_tree_like(host, first)
        if not pools:
            per_pool = _nbytes(host)
            fit = max(1, int(max_total_bytes // max(per_pool, 1)))
            if fit < kk:
                print(f"stacked_batch_pools: capping pools {kk} -> {fit} "
                      f"({per_pool / 2**20:.0f} MB per pool, "
                      f"budget {max_total_bytes / 2**30:.1f} GB)")
                kk = fit
        pools.append(_upload(host, device))
    num_batches = (len(graphs) + spec.num_graphs - 1) // spec.num_graphs
    return pools, num_batches, decode

