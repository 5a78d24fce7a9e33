#!/usr/bin/env python3
"""Name the first op whose result differs between two runs of one step.

    python3 tools/determinism_probe.py [--steps zinc,packed,...] [--graphed]
        [--list-nondeterministic] [--time-k1] [--out FILE] [--device cuda]
        [--smoke]

For each train step below, the model is built twice from one seed (its
weights, its Adam state and its dropout generator: one state), and one
eager train step runs on each from the same batch after a warm-up step.
A `TorchDispatchMode` records every aten op of the forward and backward
(in call order) with a checksum of the bits of its outputs and the
module it ran under. The probe prints one JSON line per step: the two
losses, whether the losses and every parameter gradient are bit-equal,
and the first op whose outputs differ between the two runs (its name,
its module, or "loss, backward or update" outside the forward, and its
index). Ops whose outputs start
uninitialized (`empty*`) are not compared. A hand kernel launched
through ctypes is no aten op: a difference it made shows at the op that
reads its output.

`--time-k1` times every distinct K1 call of one step (its shape and ids)
alone, CUDA-graph timed as `chip_smoke.py` times kernels (so the
wrapper's host time is not in it), slowest first, beside `zeros +
index_add_` on the same values and ids, the bytes bound, and the
longest run and largest gap of unnamed rows of its ids. `--list-nondeterministic` also runs
each step once under `torch.use_deterministic_algorithms(True,
warn_only=True)` and prints
the ops PyTorch warns have no deterministic CUDA kernel. That mode is
not a repair (it swaps `index_add_` for a sorted kernel without a word,
~65x slower at the flat layout's shape); no path of the port sets it.

The steps, by name (the shapes of `chip_smoke.py`'s phases):
  zinc     the ZINC twin's NestedGINEff (256 x 5, f32) on 128 synthetic
           molecules, uniform + dedup
  packed   the same model on packed ragged dedup batches of 128
  flat     the same model on the flat layout of those 128 molecules
  tu       `run_tu`'s CV model (BaselineGNN gin0 32 x 3, dropout 0.5) on
           a ragged batch of 128 synthetic TU graphs
  k123 ngnn i2gnn ginep ogb gps_zinc gps_pep
           the bench twin's lines (`escgnn_tpu_torch/bench.py`) on their
           batches

Needs a CUDA card unless `--device cpu` (the CPU runs the same steps and
adds in a fixed order by construction). Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import warnings
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH_STEPS = ("k123", "ngnn", "i2gnn", "ginep", "ogb", "gps_zinc",
               "gps_pep")
STEPS = ("zinc", "packed", "flat", "tu") + BENCH_STEPS
_UNINITIALIZED = ("empty", "empty_like", "new_empty", "empty_strided")


@dataclasses.dataclass
class Case:
    """One train step: `make_model()` gives the model in its one state,
    `batches` are on the device (one shape: a pool of them is stacked)."""
    name: str
    make_model: Callable
    batches: list
    loss_fn: Callable
    lr: float


def _bench_metric(name: str) -> str:
    from escgnn_tpu_torch import bench

    return {"k123": bench.K123, "ngnn": bench.NGNN, "i2gnn": bench.I2GNN,
            "ginep": bench.GINE_PLUS, "ogb": bench.OGB,
            "gps_zinc": bench.GPS_ZINC, "gps_pep": bench.GPS_PEP}[name]


def build_cases(dev, names=STEPS, num_workers: int = 2,
                smoke: bool = False) -> dict:
    """The steps `names` on `dev`, their data made from seed 0; `smoke`
    cuts the molecules to 48 (batches of 16) and the bench lines to their
    BENCH_SMOKE sets (a rehearsal on the CPU)."""
    from escgnn_tpu_torch import bench, run_tu, run_zinc
    from escgnn_tpu_torch.data.batching import (
        BatchSpec,
        batch_from_arrays,
        pad_and_batch,
        packed_batch_iterator,
    )
    from escgnn_tpu_torch.data.molecules import synthetic_zinc
    from escgnn_tpu_torch.data.tu import get_tu_dataset
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff
    from escgnn_tpu_torch.train.loop import ce_graph_loss, l1_graph_loss

    cases = {}
    zargs = run_zinc.build_parser().parse_args([])

    def zinc_model():
        return NestedGINEff(run_zinc.zinc_model_config(zargs), device=dev,
                            generator=torch.Generator().manual_seed(0))

    B = 16 if smoke else 128
    if {"zinc", "packed", "flat"} & set(names):
        graphs = featurize_many(synthetic_zinc(3 * B + B // 8, seed=0),
                                EscConfig(h=3, use_rd=True, self_loop=True),
                                num_workers=num_workers)
        first = graphs[:B]
        if "zinc" in names:
            spec = BatchSpec.uniform(graphs[:2 * B], B, enc_layout="dedup")
            cases["zinc"] = Case("zinc", zinc_model, [
                pad_and_batch(graphs[i:i + B], spec, device=dev)
                for i in (0, B)], l1_graph_loss, zargs.lr)
        if "packed" in names:
            spec = BatchSpec.from_graphs(graphs, B, enc_layout="dedup")
            cases["packed"] = Case("packed", zinc_model, [
                batch_from_arrays(a, spec, dev) for a in
                packed_batch_iterator(graphs, spec, device=None)],
                l1_graph_loss, zargs.lr)
        if "flat" in names:
            spec = BatchSpec.uniform(first, B, enc_layout="flat")
            cases["flat"] = Case("flat", zinc_model,
                                 [pad_and_batch(first, spec, device=dev)],
                                 l1_graph_loss, zargs.lr)
    if "tu" in names:
        targs = run_tu.build_parser().parse_args([])
        graphs = get_tu_dataset(targs.dataset, root=os.path.join(
            ROOT, targs.data_dir))
        classes = len({int(g.y[0]) for g in graphs})
        factory = run_tu.cv_model_factory(targs, classes,
                                          run_tu._in_dim(graphs), dev)
        bs = B if smoke else targs.batch_size
        spec = BatchSpec.from_graphs(graphs, bs)
        cases["tu"] = Case(
            "tu", lambda: factory(torch.Generator().manual_seed(0)),
            [pad_and_batch(graphs[:bs], spec, device=dev)], ce_graph_loss,
            targs.lr)
    lines = [n for n in names if n in BENCH_STEPS]
    if lines:
        gsets = bench.make_graph_sets(
            tuple(_bench_metric(n) for n in lines), smoke=smoke,
            num_workers=num_workers)
        for n in lines:
            line = bench.bench_line(_bench_metric(n), gsets, smoke)
            cases[n] = Case(
                n, lambda line=line: line.model(dev),
                [line.host_batch().to(dev)], line.loss_fn, bench.LR)
    return {n: cases[n] for n in names}


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of the bits of `t` (a device tensor, no sync)."""
    t = t.detach()
    if t.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        t = t.contiguous().view(ints[t.element_size()])
    b = t.reshape(-1).to(torch.int64)
    pos = torch.arange(1, b.numel() + 1, device=b.device) % 65521
    return torch.stack([b.sum(), (b * pos).sum()])


class _Trace(TorchDispatchMode):
    """Each aten op's (name, module, checksum of its tensor outputs)."""

    def __init__(self, where: list):
        super().__init__()
        self.where = where
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name not in _UNINITIALIZED:
            flat = out if isinstance(out, (tuple, list)) else (out,)
            sums = [_checksum(t) for t in flat
                    if isinstance(t, torch.Tensor) and t.numel() > 0]
            if sums:
                self.ops.append((str(func), self.where[-1],
                                 torch.cat(sums)))
        return out


def _module_names(model):
    names = {id(m): n or type(model).__name__
             for n, m in model.named_modules()}
    where = ["loss, backward or update"]

    def pre(mod, args):
        where.append(names.get(id(mod), type(mod).__name__))

    def post(mod, args, out):
        where.pop()

    hooks = [torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(post)]
    return where, hooks


def traced_step(case: Case, trace: bool = True) -> dict:
    """One eager train step of `case` on a fresh model (its one state):
    the loss, every parameter's gradient, and with `trace` the op list."""
    from escgnn_tpu_torch.train.loop import adam_with_plateau, train_step

    model = case.make_model()
    opt = adam_with_plateau(model.parameters(), case.lr)
    where, hooks = _module_names(model)
    tracer = _Trace(where)
    try:
        with (tracer if trace else _null()):
            loss = train_step(model, opt, case.batches[0], case.loss_fn)
    finally:
        for h in hooks:
            h.remove()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return dict(loss=loss.detach(), grads=grads, ops=tracer.ops)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def compare(a: dict, b: dict) -> dict:
    """The two runs' losses and gradients bit for bit, and the first op
    whose outputs differ."""
    loss_equal = bool(torch.equal(a["loss"], b["loss"]))
    differing = sorted(k for k in a["grads"]
                       if not torch.equal(a["grads"][k], b["grads"][k]))
    first = None
    n = min(len(a["ops"]), len(b["ops"]))
    for i in range(n):
        (op_a, at_a, sa), (op_b, at_b, sb) = a["ops"][i], b["ops"][i]
        if op_a != op_b or not torch.equal(sa, sb):
            first = dict(index=i, op=op_a, where=at_a, other_op=op_b)
            break
    if first is None and len(a["ops"]) != len(b["ops"]):
        first = dict(index=n, op="(op count differs)", where="",
                     other_op="")
    return dict(losses=[float(a["loss"]), float(b["loss"])],
                loss_equal=loss_equal, grads_equal=not differing,
                params_differing=len(differing),
                first_param_differing=differing[0] if differing else None,
                ops=len(a["ops"]), first_op_differing=first)


def eager_twice(case: Case, trace: bool = False) -> dict:
    """A warm-up step, then two eager steps from the one state."""
    traced_step(case, trace=False)
    return compare(traced_step(case, trace), traced_step(case, trace))


def graphed_twice(case: Case, reps: int = 2) -> tuple:
    """Two graphed epochs of one pool (the case's batches, `reps` times
    in order) from one state: the captured step replayed, the weights,
    Adam's state and the generators put back between the epochs.
    Returns (first losses, second losses) as lists."""
    from escgnn_tpu_torch.data.prefetch import stack_batches
    from escgnn_tpu_torch.train import loop

    pool = stack_batches(case.batches)
    model = case.make_model()
    opt = loop.adam_with_plateau(model.parameters(), case.lr,
                                 capturable=True)
    step = loop.make_pool_train_step(model, opt, case.loss_fn, pool)
    order = list(range(len(case.batches))) * reps
    snap = loop._snapshot(model, opt)
    first = step(pool, order).tolist()
    loop._restore_in_place(model, opt, snap)
    second = step(pool, order).tolist()
    return first, second


def nondeterministic_ops(case: Case) -> list:
    """The warnings one step gives under deterministic mode (restored
    after): PyTorch's list of ops with no deterministic CUDA kernel."""
    was = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            traced_step(case, trace=False)
        finally:
            torch.use_deterministic_algorithms(was)
    return sorted({str(w.message).split("\n")[0] for w in caught
                   if "deterministic" in str(w.message)})


def record_k1_calls(case: Case) -> list:
    """K1's calls in one eager step of `case` on a fresh model: each
    call's (values shape, dtype, perm, sorted ids, rows), its ids copied;
    the sums still run."""
    from escgnn_tpu_torch.ops import expand_cuda
    from escgnn_tpu_torch.train.loop import adam_with_plateau, train_step

    calls, wrapped = [], expand_cuda.sorted_segment_sum

    def record(dZ, perm, rows_sorted, num_rows):
        calls.append((tuple(dZ.shape), dZ.dtype, perm.clone(),
                      rows_sorted.clone(), int(num_rows)))
        return wrapped(dZ, perm, rows_sorted, num_rows)

    model = case.make_model()
    opt = adam_with_plateau(model.parameters(), case.lr)
    expand_cuda.sorted_segment_sum = record
    try:
        train_step(model, opt, case.batches[0], case.loss_fn)
    finally:
        expand_cuda.sorted_segment_sum = wrapped
    return calls


def distinct_k1_calls(calls: list) -> list:
    """`record_k1_calls`' calls, one of each (shape, dtype, rows, perm,
    sorted ids), in first-call order: [(call, times it was made)]."""
    seen: dict = {}
    for call in calls:
        (E, H), dtype, perm, rows, R = call
        key = (E, H, dtype, R, perm.cpu().numpy().tobytes(),
               rows.cpu().numpy().tobytes())
        if key in seen:
            seen[key][1] += 1
        else:
            seen[key] = [call, 1]
    return [tuple(v) for v in seen.values()]


def ids_stats(rows, R: int) -> dict:
    """Of sorted ids over R rows: the longest run of one id, the largest
    stretch of rows no id names, and the positions dropped (ids outside
    [0, R))."""
    keep = rows[(rows >= 0) & (rows < R)].long()
    counts = torch.bincount(keep, minlength=R)[:R]
    named = torch.cat([torch.tensor([-1], device=rows.device),
                       torch.nonzero(counts).flatten(),
                       torch.tensor([R], device=rows.device)])
    return dict(longest_run=int(counts.max()) if R else 0,
                largest_gap=int((named[1:] - named[:-1] - 1).max()),
                dropped=int(rows.numel() - keep.numel()))


def index_add_sum(dZ, perm, rows, R: int):
    """`zeros + index_add_` computing K1's sum on the same values: the
    unsorted ids (positions outside [0, R) sent to a trash row past the
    end, as K1 drops them), built outside the returned call."""
    ids = torch.empty_like(rows).scatter_(0, perm.long(), rows).long()
    ids = torch.where((ids >= 0) & (ids < R), ids, R)
    H, dtype = dZ.shape[1], dZ.dtype
    return lambda: torch.zeros(R + 1, H, dtype=dtype,
                               device=dZ.device).index_add_(0, ids, dZ)


def k1_bound_ms(dZ, perm, rows, R: int) -> tuple:
    """(least ms on an H100 SXM, "bytes" or "operations"): K1's charge
    (`segsum_cost`: the positions in range read once, the output written
    once) over 3.35 TB/s, its FLOPs over 67 TFLOP/s f32."""
    from chip_smoke import _bound
    from escgnn_tpu_torch.ops import expand_cuda

    flops, _, nbytes = expand_cuda.segsum_cost(dZ, perm, rows, R)
    return _bound(nbytes, flops)


def k1_call_times(case: Case) -> list:
    """Every distinct K1 call of one eager step of `case`, CUDA-graph
    timed alone on random values of its shape (`chip_smoke._cuda_ms`)
    beside `index_add_sum`: [dict(shape, rows, count, longest_run,
    largest_gap, dropped, k1_ms, index_add_ms, bound_ms)], slowest
    first."""
    from chip_smoke import _cuda_ms
    from escgnn_tpu_torch.ops import expand_cuda

    out = []
    for call, count in distinct_k1_calls(record_k1_calls(case)):
        (E, H), dtype, perm, rows, R = call
        dZ = torch.randn(E, H, device=perm.device).to(dtype)
        k1 = _cuda_ms(lambda: expand_cuda.sorted_segment_sum(dZ, perm, rows,
                                                             R))
        lib = _cuda_ms(index_add_sum(dZ, perm, rows, R))
        out.append(dict(shape=[E, H, str(dtype)[6:]], rows=R, count=count,
                        **ids_stats(rows, R), k1_ms=k1, index_add_ms=lib,
                        bound_ms=k1_bound_ms(dZ, perm, rows, R)[0]))
    return sorted(out, key=lambda c: -c["k1_ms"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", default=",".join(STEPS))
    p.add_argument("--device", default="cuda")
    p.add_argument("--list-nondeterministic", action="store_true")
    p.add_argument("--graphed", action="store_true",
                   help="also two graphed epochs per step (card only)")
    p.add_argument("--out", default=None, help="also write the lines here")
    p.add_argument("--smoke", action="store_true",
                   help="small data (a rehearsal on the CPU)")
    p.add_argument("--time-k1", action="store_true",
                   help="time each K1 call of one step alone (card only)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("determinism_probe: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = [n for n in args.steps.split(",") if n]
    unknown = set(names) - set(STEPS)
    if unknown:
        p.error(f"unknown steps {sorted(unknown)}; known: {STEPS}")
    cases = build_cases(dev, names, smoke=args.smoke)
    lines = []
    for name, case in cases.items():
        res = dict(step=name, **eager_twice(case, trace=True))
        if args.graphed and dev.type == "cuda":
            first, second = graphed_twice(case)
            res.update(graphed_losses=[first, second],
                       graphed_equal=first == second)
        if args.list_nondeterministic and dev.type == "cuda":
            res["nondeterministic_ops"] = nondeterministic_ops(case)
        if args.time_k1 and dev.type == "cuda":
            res["k1_calls"] = k1_call_times(case)
        if dev.type == "cuda":
            res["device"] = torch.cuda.get_device_name(dev)
        line = json.dumps(res)
        print(line, flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
