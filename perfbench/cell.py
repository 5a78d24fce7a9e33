"""One run of one cell: set-up, the first three train steps that the
correctness check follows, the measured window of whole epochs, with
`--trace 1` the traced tail, and the comparison with the plain reference.

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`),
a traffic mix (`traffic/<name>.json`) and its limits
(`limits/<cell>.json`); each metric it reports has a reader
(`metrics/<name>.py`). Nothing here names a cell, a configuration or a
metric."""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np
import torch

from perfbench import checks, port, refcheck, trace, weights
from perfbench.reference import batch as rbatch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "escgnn_tpu")
TRACED_STEPS = 100  # per-step events over at least this many steps
B1 = 0.9  # Adam's first-moment decay: the first step's m is (1 - B1) g


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, bench: dict | None = None,
            root: str = ROOT) -> dict:
    """The cell `workload` with its configuration, traffic, limits and the
    metrics it reports, found by the names in `BENCHMARK.json` (or
    `bench`) under the checkout `root`."""
    if bench is None:
        bench = _json(os.path.join(root, "BENCHMARK.json"))
    here = os.path.join(root, "perfbench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    metrics = [dict(m, kind="end_to_end") for m in bench["end_to_end"]]
    metrics += [dict(m, kind="per_layer") for m in bench["per_layer"]]
    reported = {m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])}
    mine = []
    for m in metrics:
        if workload not in m.get("workloads", [workload]):
            continue
        if m["kind"] == "per_layer" and m["moves"] not in reported:
            continue
        mine.append(m)
    return dict(
        cell=cell,
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(here, "traffic", cell["traffic"]
                                   + ".json")),
        limits=_json(os.path.join(here, "limits", workload + ".json")),
        metrics=mine,
        readers={m["name"]: os.path.join(here, "metrics", m["name"] + ".py")
                 for m in mine},
    )


def reader(path: str):
    """The `read(r)` of a metric's reader file."""
    name = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list:
    """The top-level names of JAX's modules and the JAX package's among
    `modules` (the loaded ones by default), compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def split(raw: list, shares: list) -> dict:
    """The 80/10/10 split of the drivers: train, val, then test."""
    n_tr = int(shares[0] * len(raw))
    n_val = int(shares[1] * len(raw))
    return {"train": raw[:n_tr], "val": raw[n_tr:n_tr + n_val],
            "test": raw[n_tr + n_val:]}


def normalized_targets(parts: dict, task: dict) -> dict:
    """Each graph's targets standardized as the task's driver does it."""
    col = task.get("target")

    def pick(g):
        y = np.asarray(g.y, np.float64)
        return y[:, [col]] if col is not None else y

    stat = np.concatenate([pick(g).reshape(-1) for s in task["stats_from"]
                           for g in parts[s]])
    mean, std = float(stat.mean()), float(stat.std(ddof=task["ddof"]))
    std = max(std, 1e-8)
    return {s: [((pick(g) - mean) / std).astype(np.float32) for g in gs]
            for s, gs in parts.items()}


def workers() -> int:
    """Processes for data generation, featurization and the reference's
    encoding: one per CPU, at most 8."""
    return min(8, os.cpu_count() or 1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """The state of one run; `main` drives it."""

    def __init__(self, res: dict, seed: int, seconds: float, traced: bool,
                 device, t_start: float, workers: int):
        self.res, self.seed, self.seconds = res, int(seed), float(seconds)
        self.traced, self.device, self.t_start = traced, device, t_start
        self.workers = workers
        self.cfg, self.trf = res["config"], res["traffic"]
        self.r: dict = dict(spans={}, counters={}, trace={}, peaks=_json(
            os.path.join(HERE, "peaks.json")))

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        cfg, trf, dev = self.cfg, self.trf, self.device
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
        marks = self.r["setup_marks"] = [("start", self.t_start),
                                          ("imports", time.time())]
        gen = importlib.import_module(f"perfbench.gen.{trf['generator']}")
        raw = gen.generate(trf["data"], self.seed, self.workers)
        marks.append(("generate", time.time()))
        self.raw = split(raw, trf["split"])
        self.ys = normalized_targets(self.raw, cfg["task"])
        t = time.time()
        self.graphs = {s: port.featurize(self.raw[s], self.ys[s], cfg["esc"],
                                         self.workers) for s in self.raw}
        self.r["spans"]["featurize"] = time.time() - t
        marks.append(("featurize", time.time()))

        t = time.time()
        allg = [g for s in ("train", "val", "test") for g in self.graphs[s]]
        bs = trf["batch_size"]
        m = cfg["model"]
        system = port.system(m["system"])
        self.spec = system.batch_spec(allg, bs, cfg["layout"])
        self.pools, self.n = port.train_pools(
            self.graphs["train"], self.spec, trf["membership_pools"],
            self.seed, dev)
        self.parts = trf["epoch"]
        self.stacks = {}
        if "refresh" in self.parts:
            self.stacks["refresh"] = port.stack(
                self.graphs["train"][:trf["refresh_batches"] * bs],
                self.spec, dev)
        for s in ("val", "test"):
            if s in self.parts:
                self.stacks[s] = port.stack(self.graphs[s], self.spec, dev)
        _sync(dev)
        self.r["spans"]["pool_build"] = time.time() - t
        marks.append(("pools", time.time()))

        self.model = system.build(m["fields"], self.spec,
                                  int(np.asarray(self.raw["train"][0].x)
                                      .shape[1]), dev)
        _sync(dev)
        marks.append(("model_build", time.time()))
        self.w0 = weights.draw(self.model, self.seed, dev, system.draw_rule)
        weights.load(self.model, self.w0)
        self.opt = port.optimizer(self.model, cfg["optimizer"],
                                  capturable=dev.type == "cuda")
        self.loss = port.loss_fn(cfg["task"]["loss"])
        _sync(dev)
        marks.append(("weights_optimizer", time.time()))
        dots, k1 = [], []
        with (trace.captured_dots(dots) if self.traced and dev.type == "cuda"
              else contextlib.nullcontext()), \
                (trace.k1_calls(k1) if self.traced
                 else contextlib.nullcontext()):
            self.step = port.pool_train_step(self.model, self.opt, self.loss,
                                             self.pools[0])
        if dots:
            self.r["counters"]["kernel_nodes_per_step"] = trace.dot_nodes(
                dots[0], "{KERNEL")
        if k1:  # the warm-up's three eager steps: keep the first one's
            self.r["counters"]["k1_calls"] = k1[:len(k1) // 3]
        self.refresh_pool, self.eval_pool = port.eval_steps(
            self.model, node_level=cfg["task"]["level"] == "node",
            bn_eval=cfg["bn_eval"])
        self.sched = port.plateau(cfg["optimizer"])
        self.rng = np.random.default_rng(self.seed)
        _sync(dev)
        marks.append(("capture", time.time()))
        self.first_steps()
        marks.append(("first_steps", time.time()))
        self.r["edges_per_epoch"] = int(sum(g.num_edges for g in
                                            self.graphs["train"]))
        cost = importlib.import_module(f"perfbench.costs.{cfg['name']}")
        tr = self.graphs["train"]
        self.r["flops_per_epoch"] = cost.flops(dict(
            graphs=len(tr),
            nodes=np.asarray([g.num_nodes for g in tr], np.int64),
            edges=np.asarray([g.num_edges for g in tr], np.int64),
            nnz=port.nnz_per_graph(tr)), m["fields"])
        _sync(dev)

    def first_steps(self) -> None:
        """In an epoch cell, the BN refresh and both evals from the drawn
        weights; then the first three steps, each on its own batch of
        pool 0, through the window's own call. The readings the reference
        is held to."""
        self.sys_read = {}
        if "refresh" in self.parts:
            self.refresh_pool(self.stacks["refresh"])
            self.sys_read["stats"] = {
                k: float(torch.linalg.vector_norm(v.double()))
                for k, v in self.model.named_buffers()
                if k.rsplit(".", 1)[-1] in ("running_mean", "running_var")}
            for s in ("val", "test"):
                e, c = self.eval_pool(self.stacks[s])
                self.sys_read[s] = float(e) / max(float(c), 1.0)
        order = self.rng.permutation(self.n)
        self.check_batches = [int(j) for j in order[:3]]
        params = dict(self.model.named_parameters())
        l1 = self.step(self.pools[0], self.check_batches[:1])
        grad1 = {}
        for k, p in params.items():
            m = self.opt.state.get(p, {}).get("exp_avg")  # none: no update
            grad1[k] = (0.0 if m is None else
                        float(torch.linalg.vector_norm(m.double() / (1 - B1))))
        l23 = self.step(self.pools[0], self.check_batches[1:])
        change = {k: float(torch.linalg.vector_norm(
            (p.detach() - self.w0[k]).double())) for k, p in params.items()}
        self.sys_read.update(losses=torch.cat([l1, l23]).tolist(),
                             grad1=grad1, change=change)

    # -- one epoch ------------------------------------------------------------

    def epoch(self, e: int, spans: bool = False) -> dict:
        """`fit`'s epoch: one pool step over pool (e - 1) % k in a fresh
        order, its one wait, then the parts the traffic names (BN refresh,
        val eval and the plateau scheduler, test eval)."""
        def span(name):
            return (torch.profiler.record_function(f"perfbench.{name}")
                    if spans else contextlib.nullcontext())

        t0 = time.time()
        with span("step_call"):
            losses = self.step(self.pools[(e - 1) % len(self.pools)],
                               self.rng.permutation(self.n))
        t1 = time.time()
        with span("loss_read"):  # the epoch's one wait, as in `fit`
            _, bad = torch.stack([
                losses.mean(), (~torch.isfinite(losses)).sum().to(
                    losses.dtype)]).tolist()
        t2 = time.time()
        if "refresh" in self.parts:
            with span("refresh"):
                self.refresh_pool(self.stacks["refresh"])
        if "val" in self.parts:
            with span("eval"):
                ev, cv = self.eval_pool(self.stacks["val"])
                val = float(ev) / max(float(cv), 1.0)
            lr = port.get_lr(self.opt)
            new_lr = self.sched.step(val, lr)
            if new_lr != lr:
                port.set_lr(self.opt, new_lr)
        if "test" in self.parts:
            with span("eval"):
                et, ct = self.eval_pool(self.stacks["test"])
                float(et) / max(float(ct), 1.0)
        t3 = time.time()
        return dict(steps=int(losses.shape[0]), failed=int(bad),
                    host_step_s=t1 - t0, train_pass_s=t2 - t0,
                    eval_refresh_s=t3 - t2)

    # -- the window -----------------------------------------------------------

    def window(self) -> None:
        _sync(self.device)
        t0 = time.time()
        self.r["setup_s"] = t0 - self.t_start
        eps = []
        while not eps or time.time() - t0 < self.seconds:
            eps.append(self.epoch(len(eps) + 1))
        t1 = time.time()
        self.next_epoch = len(eps) + 1
        w = dict(seconds=t1 - t0, epochs=len(eps),
                 steps=sum(e["steps"] for e in eps),
                 failed=sum(e["failed"] for e in eps))
        w["edges"] = w["epochs"] * self.r["edges_per_epoch"]
        w["flops"] = w["epochs"] * self.r["flops_per_epoch"]
        c = self.r["counters"]
        c["host_step_s"] = sum(e["host_step_s"] for e in eps)
        c["train_pass_s"] = [e["train_pass_s"] for e in eps]
        c["eval_refresh_s"] = [e["eval_refresh_s"] for e in eps]
        self.r["window"] = w

    # -- the traced tail ------------------------------------------------------

    def traced_tail(self) -> None:
        """Per-step CUDA events over at least `TRACED_STEPS` steps, then the
        profiler over one more epoch."""
        dev = self.device
        ev_epochs = math.ceil(TRACED_STEPS / self.n)
        events = []
        for i in range(ev_epochs):
            pool = self.pools[(self.next_epoch + i - 1) % len(self.pools)]
            for j in self.rng.permutation(self.n):
                self.step(pool, [int(j)])
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
        torch.cuda.synchronize(dev)
        ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        self.r["counters"]["step_ms"] = ms
        q = np.percentile(ms, [5, 50, 95])
        print(f"traced steps {len(ms)}: ms p5 {q[0]:.4f} p50 {q[1]:.4f} "
              f"p95 {q[2]:.4f}", file=sys.stderr)
        self.next_epoch += ev_epochs

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("perfbench.tail"):
                ep = self.epoch(self.next_epoch, spans=True)
                torch.cuda.synchronize(dev)
        names = {f"perfbench.{s}" for s in ("tail", "step_call", "loss_read",
                                            "refresh", "eval")}
        got = trace.read_profile(prof, names)
        tail = [s for s in got["spans"] if s[0] == "perfbench.tail"]
        if not tail:
            raise RuntimeError("the profiler kept no span of the tail")
        _, t0, t1 = tail[0]
        dev_ops = [d for d in got["device"] if t0 <= d[1] <= t1]
        kernels = [d for d in dev_ops if d[3] == "kernel"]
        k1 = [d for d in kernels if trace.K1_SYMBOL in d[0]]
        self.r["trace"] = dict(
            window_s=(t1 - t0) * 1e-6,
            busy_s=trace.union_seconds([(a, b) for _, a, b, _ in dev_ops]),
            records=len(kernels),
            replays=ep["steps"],
            k1_mean_s=(sum(b - a for _, a, b, _ in k1) / len(k1) * 1e-6
                       if k1 else None),
            device_ops=trace.top_ops(dev_ops),
            idle_gaps=sorted(
                ([k, v] for k, v in trace.idle_gaps(
                    dev_ops, [s for s in got["spans"]
                              if s[0] != "perfbench.tail"], t0, t1).items()),
                key=lambda kv: -kv[1])[:10],
        )

    # -- the reference --------------------------------------------------------

    def groups(self) -> dict:
        """The graphs (with normalized targets) of each batch the check
        covers: pool 0's three batches, and in an epoch cell the refresh,
        val and test batches, each in the order the system stacked it."""
        bs = self.trf["batch_size"]
        train = list(zip(self.raw["train"], self.ys["train"]))
        perm = np.random.default_rng(self.seed).permutation(len(train))
        pool0 = [train[int(i)] for i in perm]
        out = {"train": [pool0[j * bs:(j + 1) * bs]
                         for j in self.check_batches]}
        if "refresh" in self.parts:
            ref = train[:self.trf["refresh_batches"] * bs]
            out["refresh"] = [ref[i:i + bs] for i in range(0, len(ref), bs)]
            for s in ("val", "test"):
                gs = list(zip(self.raw[s], self.ys[s]))
                out[s] = [gs[i:i + bs] for i in range(0, len(gs), bs)]
        return out

    def free_system(self) -> None:
        for k in ("step", "pools", "stacks", "model", "opt", "refresh_pool",
                  "eval_pool", "graphs"):
            setattr(self, k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_batches(self, groups: dict) -> dict:
        enc = refcheck.encode_groups(groups, self.cfg["esc"]["h"],
                                     self.workers)
        return refcheck.make_batches(groups, enc, self.device)

    def compare(self) -> dict:
        """Each gap with its limit; `correct` if every one is within."""
        batches = self.reference_batches(self.groups())
        m = self.cfg["model"]
        ref = refcheck.readings(m["reference"], m["fields"], self.w0, batches,
                                self.cfg["optimizer"])
        got = checks.gaps(self.sys_read, ref)
        self.readings = got
        lim = self.res["limits"]
        missing = set(lim) - set(got)
        if missing:
            raise RuntimeError(f"limits name no check: {sorted(missing)}")
        return {k: dict(value=got[k], limit=lim[k]) for k in lim}

    # -- the metrics ----------------------------------------------------------

    def metrics(self) -> dict:
        out = {}
        for m in self.res["metrics"]:
            if (m["kind"] == "end_to_end") == self.traced:
                continue
            v = reader(self.res["readers"][m["name"]])(self.r)
            if v is not None:
                out[m["name"]] = dict(value=v, unit=m["unit"])
        return out


def device_info(device, count: int) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=count,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))


def run(res: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float, workers: int, log=sys.stderr) -> dict:
    """One run; returns the result line's object (without printing it)."""
    run = Run(res, seed, seconds, traced, device, t_start, workers)
    run.setup()
    run.window()
    if traced and device.type == "cuda":
        run.traced_tail()
    dev = device_info(device, res["cell"]["chips"])
    mets = run.metrics()
    w = run.r["window"]
    tr = run.r["trace"]
    if traced and tr:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        nodes = run.r["counters"].get("kernel_nodes_per_step")
        if nodes:
            print(f"profiler kept {tr['records']} kernel records of "
                  f"{nodes * tr['replays']} expected (kernel nodes "
                  f"{nodes} x replays {tr['replays']}): "
                  f"{tr['records'] / (nodes * tr['replays']):.4f}", file=log)
    marks = run.r["setup_marks"]
    print("set-up seconds: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
        file=log)
    if device.type == "cuda":
        print(f"peak device memory reserved "
              f"{torch.cuda.max_memory_reserved(device)} bytes", file=log)
    run.free_system()
    lim = run.compare()
    print("readings (compared or not): " + ", ".join(
        f"{k} {v!r}" for k, v in run.readings.items()), file=log)
    correct = all(v["value"] <= v["limit"] for v in lim.values())
    out = dict(correct=correct, attempted=w["steps"], failed=w["failed"],
               metrics=mets, device=dev)
    if traced and tr:
        out["breakdown"] = dict(device_ops=tr["device_ops"],
                                idle_gaps=tr["idle_gaps"])
    out["checks"] = lim
    return out
