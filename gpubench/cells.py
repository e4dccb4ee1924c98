"""One run of one cell: set-up, warm-up, the measured window, the check.

Two kinds of traffic, named by a traffic file's ``kind``:

* ``train``: ``Trainer.train_epoch`` of the port over the configuration's
  graph.  Set-up builds the Trainer, gives it the benchmark's weights
  and, with a control variate, a history table drawn from the seed (so the
  first step's full term and sampled delta read it, as every step after an
  epoch does), drives it through its first ``CHECK_STEPS`` steps one batch at a time
  through ``train_epoch`` (the window's own call and feed: the first rows
  of a shuffled epoch), recording what the steps drew and produced; those
  steps are the warm-up (every shape of an epoch, every kernel built).
  The window is a whole number of epochs, the first ``seconds`` of them
  and the one that crosses the mark.
* ``predict``: set-up builds a Trainer with the benchmark's weights,
  exports its predictor into the run's temporary directory
  (``serving.export_predictor``), frees it, loads the artifact
  (``load_predictor``) and deletes it, then sends requests for
  ``WARMUP_SECONDS``.  The window sends closed-loop
  requests of ``request_ids`` distinct node ids from one client, each
  timed from the call to the probabilities on the host.

Device memory: for training from before the Trainer is built, for serving
from ``load_predictor`` on (the benchmark's own copy of the inputs waits
on the host meanwhile).  The reference runs after the window, once the
peak has been read and the port's state freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import check, counts, data, model, peaks, reference, trace
from .readings import Readings, load_reader

TRACE_SECONDS = 3.0          # a traced window: whole units up to this
CHECK_STEPS = 3              # train steps the reference follows
WARMUP_SECONDS = 3.0         # served requests after the first, unmeasured
CHECKED_REQUESTS = 8         # answered requests the reference scores
MIN_REQUEST_S = 0.004        # the request pool covers a window this fast
OUT_DIR = "bench_out"        # the host-paced lines of a run, as files


def stream(seed: int, i: int) -> int:
    """The seed of the run's ``i``-th generator: 0 data, 1 weights, 2
    requests, 3 the sample of checked answers."""
    return int(seed) * 8 + i


@dataclass
class Run:
    bench: object
    cell: object
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    out: dict = field(default_factory=dict)      # the result's fields
    info: dict = field(default_factory=dict)     # stderr / bench_out lines

    def phase(self, name: str) -> None:
        """Seconds of set-up since the last phase (or the process start)."""
        now = time.perf_counter()
        phases = self.info.setdefault("setup_phases", {})
        phases[name] = now - self.t0 - sum(phases.values())

    def log(self, msg: str) -> None:
        print(f"gpubench: {msg}", file=sys.stderr, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _allocated(dev):
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def port_config(config: dict, traffic: dict, seed: int):
    """The port's ``Config`` of a configuration and a traffic mix: every key
    of either that is a ``Config`` field."""
    from stochastic_gcn_tpu_torch.config import Config
    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for src in (config, traffic) for k, v in src.items()
          if k in names}
    return Config(**kw, seed=int(seed) % 2 ** 63)


def _steps(config: dict, preprocess: bool) -> list:
    return model.layers(config, int(config["feature_dim"]),
                        int(config["num_classes"]), preprocess)


# ------------------------------ training ---------------------------------

class _OneBatch:
    """A train iterator that holds one batch and does not reshuffle."""

    def __init__(self, ids: np.ndarray):
        self.data = ids

    def shuffle(self) -> None:
        pass


@contextlib.contextmanager
def recording():
    """Record, while open, each schedule the port's train step builds
    (``training/step.py::_schedule``) and the mask of each dropout it
    applies (``ops/layers.py::dropout``), read off its input and output as
    ``MASK_*`` codes (where the input is zero the mask cannot be read and
    does not matter).  Both are module attributes the port looks up at
    call time; both are put back."""
    from stochastic_gcn_tpu_torch.ops import layers as L
    from stochastic_gcn_tpu_torch.training import step as S
    rec = {"packs": [], "masks": []}
    schedule, dropout = S._schedule, L.dropout

    def _schedule(*a, **kw):
        pack = schedule(*a, **kw)
        rec["packs"].append(pack)
        return pack

    def _dropout(gen, x, keep_prob, block=None):
        out = dropout(gen, x, keep_prob, block)
        if isinstance(out, torch.Tensor) and keep_prob < 1.0:
            rec["masks"].append(((x != 0).to(torch.uint8)
                                 + (out != 0).to(torch.uint8)).cpu())
        return out

    S._schedule, L.dropout = _schedule, _dropout
    try:
        yield rec
    finally:
        S._schedule, L.dropout = schedule, dropout


def record_steps(tr, k: int):
    """Drive the Trainer ``tr`` through ``k`` steps, one batch each through
    ``train_epoch``, on the first ``k`` batches of a shuffled epoch; return
    the port's side of the check (``losses``, ``grad1`` from Adam's first
    moment after step 1, ``params`` after step ``k``) and the draws."""
    it, cfg = tr.train_iter, tr.cfg
    n, b = tr.ds.num_data, cfg.batch_size
    it.shuffle()
    ids = it.data.copy()
    draws, grad1 = [], None
    try:
        with recording() as rec:
            for i in range(k):
                rec["packs"].clear()
                rec["masks"].clear()
                tr.train_iter = _OneBatch(ids[i * b:(i + 1) * b])
                loss = tr.train_epoch()[0]
                pack, = rec["packs"]
                d = reference.Draw(fields=[f.cpu() for f in pack.fields],
                                   masks=list(rec["masks"]), loss=loss)
                if cfg.cv:
                    d.slot_pos = pack.layers[0].slot_pos.cpu()
                    d.slot_w = pack.layers[0].slot_w.cpu()
                    f0 = pack.fields[0].long()
                    hid = torch.unique(f0[f0 < n])
                    d.hist_ids = hid.cpu()
                    d.hist_rows = tr.state.histories[0][0].index_select(
                        0, hid).float().cpu()
                if i == 0:
                    grad1 = {k_: (t / (1.0 - cfg.beta1)).cpu() for k_, t in
                             check.flat(tr.state.opt_state.mu).items()}
                draws.append(d)
    finally:
        tr.train_iter = it
    prog = {"losses": [d.loss for d in draws], "grad1": grad1,
            "params": model.clone(tr.state.params, "cpu")}
    return prog, draws


def _cap(cfg) -> Optional[int]:
    """The port's cap on a padded graph's rows (None: every edge)."""
    return cfg.pad_degree if cfg.pad_degree > 0 else None


def graph_rows(g, cfg, train: bool) -> reference.Rows:
    """The reference's derivation of the train (or full) graph as the
    port's padded graph holds it, on ``g``'s device."""
    ip, ix = (g.train_indptr, g.train_indices) if train else (g.indptr,
                                                               g.indices)
    return reference.graph_rows(ip, ix, _cap(cfg), cfg.seed)


def _estimator(cfg) -> dict:
    return {"cv": cfg.cv, "preprocess": cfg.preprocess,
            "keep_prob": cfg.keep_prob, "learning_rate": cfg.learning_rate,
            "beta1": cfg.beta1, "beta2": cfg.beta2,
            "weight_decay": cfg.weight_decay,
            "history_dtype": cfg.history_dtype}


def _batches(order: np.ndarray, b: int, n: int) -> np.ndarray:
    s = -(-len(order) // b)
    out = np.full(s * b, n, np.int64)
    out[:len(order)] = order
    return out.reshape(s, b)


def seed_history(tr, seed: int):
    """Write a history table drawn from ``seed`` (rectified Gaussian
    rows, as the rows after a layer norm and a ReLU, rounded to the
    configuration's storage dtype) into the Trainer's first train
    history; return it on the host as float32 (None without a control
    variate)."""
    if not tr.cfg.cv:
        return None
    hist = tr.state.histories[0][0]
    n = tr.ds.num_data
    gen = torch.Generator(device=hist.device).manual_seed(seed)
    rows = torch.randn((n, hist.shape[1]), generator=gen,
                       device=hist.device).clamp_(min=0.0)
    stored = getattr(torch, tr.cfg.history_dtype)
    rows = rows.to(stored).float()
    hist[:n].copy_(rows)
    return rows.cpu()


def train_setup(r: Run):
    """The inputs drawn, the port's Trainer built with the benchmark's
    weights (and history table) and driven through the check steps:
    ``(trainer, graph on the host, model steps, initial weights on the
    host, the initial history on the host or None, the port's side of the
    check, its draws)``.  The device's peak counts from the Trainer's
    build."""
    from stochastic_gcn_tpu_torch.training.loop import Trainer
    dev, config, traffic = r.device, r.config, r.traffic
    r.phase("imports")
    g = data.draw(config, stream(r.seed, 0), dev)
    _sync(dev)
    r.phase("draw")
    ds = data.to_dataset(g, bool(config["preprocess"]))
    g = g.to("cpu")
    _free(dev)
    _reset_peak(dev)
    r.phase("dataset")
    tr = Trainer(port_config(config, traffic, r.seed), ds, device=dev)
    steps = _steps(config, tr.cfg.preprocess)
    params0 = model.make_weights(steps, stream(r.seed, 1), dev)
    model.load_weights(params0, tr.state.params)
    params0 = model.clone(params0, "cpu")
    hist0 = seed_history(tr, stream(r.seed, 4))
    _sync(dev)
    r.phase("trainer")
    prog, draws = record_steps(tr, CHECK_STEPS)
    r.phase("check_steps")
    return tr, g, steps, params0, hist0, prog, draws


def train_reference(g, rows, steps, params0, hist0, cfg, draws,
                    precision: str = "float32", half_batch: bool = False):
    """The reference over the port's recorded steps, on the device of
    ``g`` (the graph) and ``rows`` (:func:`graph_rows`)."""
    return reference.train_steps(g, steps, params0, _estimator(cfg), rows,
                                 draws, precision, half_batch, hist0)


def run_train(r: Run) -> None:
    dev, config = r.device, r.config
    tr, g, steps, params0, hist0, prog, draws = train_setup(r)
    cfg = tr.cfg
    # no warm-up beyond the check steps: their batches have the epoch's
    # shapes (the fields' capacities are static) and built every kernel
    _sync(dev)
    hist = [h for hl in (*tr.state.histories, *tr.eval_histories)
            for h in hl]
    memory = {"resident_bytes": _allocated(dev),
              "history_bytes": sum(h.numel() * h.element_size()
                                   for h in hist)}
    setup_s = time.perf_counter() - r.t0
    length = min(r.seconds, TRACE_SECONDS) if r.trace else r.seconds
    orders, epochs, n_steps = [], 0, 0
    amt0 = tr.amt_data
    with trace.profiled(r.trace) as prof:
        t0 = time.perf_counter()
        while True:
            n_steps += tr.train_epoch()[3]
            epochs += 1
            orders.append(tr.train_iter.data.copy())
            if time.perf_counter() - t0 >= length:
                break
        window_s = time.perf_counter() - t0
    peak = _peak(dev)
    n_train = len(tr.train_iter.data)
    nodes = epochs * n_train
    r.info.update(window_s=window_s, epochs=epochs, steps=n_steps,
                  train_nodes_per_s=nodes / window_s,
                  amt_data_edges_per_s=(tr.amt_data - amt0) / window_s)
    r.log(f"train: {epochs} epochs, {n_steps} steps, {nodes} nodes in "
          f"{window_s:.4f} s: {nodes / window_s:.1f} nodes/s; the "
          f"reference's accounting (amt_data): "
          f"{(tr.amt_data - amt0) / window_s:.1f} sampled edges/s "
          "(BASELINE.md's host bound of the reference: 3.9e5 at batch 512)")
    del tr
    _free(dev)

    gd = g.to(dev)
    rows = graph_rows(gd, cfg, True)
    ref = train_reference(gd, rows, steps, params0, hist0, cfg, draws)
    numbers = check.train_numbers(prog, ref, params0, _estimator(cfg))
    r.info.update(check.train_details(prog, ref, params0),
                  history=ref.history_detail, keep_share=ref.keep_share,
                  draw_bins=[t.tolist() for t in ref.draw_bins],
                  numbers=numbers)
    summary = trace.summarize(prof, window_s) if r.trace else None
    cnt = {}
    if r.trace:
        for order in orders:
            for batch in _batches(order, cfg.batch_size, g.num_nodes):
                bt = torch.from_numpy(batch).to(dev)
                if cfg.cv:
                    cnt["full_term_bytes"] = cnt.get("full_term_bytes", 0.0) \
                        + counts.full_term_step(
                            rows.indptr, rows.indices, bt,
                            int(config["hidden1"]),
                            2 if cfg.history_dtype == "bfloat16" else 4)
                else:
                    for k, v in counts.exact_step(
                            rows.indptr, rows.indices, bt, steps,
                            int(config["feature_dim"]), True).items():
                        cnt[k] = cnt.get(k, 0.0) + v
        r.info.update(kernels_per_step=summary.kernels / max(n_steps, 1),
                      idle_share=1.0 - summary.busy_s / window_s)
        if "full_term_bytes" in cnt:
            secs = summary.seconds_of(["split_gather_kernel"])
            if secs > 0:
                r.info["full_term_bound_share"] = \
                    cnt["full_term_bytes"] / peaks.HBM_BYTES_PER_S / secs
    r.out.update(values={"train_nodes_per_s": nodes / window_s,
                         "peak_mem_gib": peak / 2.0 ** 30,
                         "setup_s": setup_s},
                 readings=Readings(trace=summary, counts=cnt, memory=memory),
                 numbers=numbers, attempted=n_steps, failed=0, peak=peak,
                 window_s=window_s)


# ------------------------------ serving ----------------------------------

def request_pool(n: int, k: int, count: int, seed: int, dev) -> np.ndarray:
    """``[count, k]`` node ids, each row ``k`` distinct ids drawn uniformly
    from ``n`` (rows cut from random permutations)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    per = max(1, n // k)
    perms = [torch.randperm(n, generator=gen, device=dev)[:per * k]
             .view(per, k) for _ in range(-(-count // per))]
    return torch.cat(perms)[:count].to(torch.int32).cpu().numpy()


def run_predict(r: Run) -> None:
    from stochastic_gcn_tpu_torch.serving import (export_predictor,
                                                  load_predictor)
    from stochastic_gcn_tpu_torch.training.loop import Trainer
    dev, config, traffic = r.device, r.config, r.traffic
    r.phase("imports")
    g = data.draw(config, stream(r.seed, 0), dev)
    ds = data.to_dataset(g, bool(config["preprocess"]))
    g = g.to("cpu")
    r.phase("draw_dataset")
    cfg = port_config(config, traffic, r.seed)
    tr = Trainer(cfg, ds, device=dev)
    steps = _steps(config, cfg.test_preprocess)
    params0 = model.make_weights(steps, stream(r.seed, 1), dev)
    model.load_weights(params0, tr.state.params)
    params0 = model.clone(params0, "cpu")
    art = Path(tempfile.gettempdir()) / "gpubench" / r.cell.name
    shutil.rmtree(art, ignore_errors=True)
    r.phase("trainer")
    export_predictor(tr, str(art))
    del tr, ds
    _free(dev)
    _reset_peak(dev)
    r.phase("export")
    pred = load_predictor(str(art), device=dev)
    shutil.rmtree(art, ignore_errors=True)
    r.phase("load")
    k = int(traffic["request_ids"])
    warm = int(math.ceil(WARMUP_SECONDS / MIN_REQUEST_S))
    count = warm + int(math.ceil(r.seconds / MIN_REQUEST_S))
    pool = request_pool(g.num_nodes, k, count, stream(r.seed, 2), dev)
    # warm-up: a first request (in a checkout's first run it builds the
    # kernels), then requests for a fixed time, as the card and the host
    # settle over the first seconds
    pred.predict(pool[count - 1])
    t0, i = time.perf_counter(), 1
    while time.perf_counter() - t0 < WARMUP_SECONDS:
        pred.predict(pool[count - 1 - i % warm])
        i += 1
    _sync(dev)
    r.phase("warmup")
    memory = {"resident_bytes": _allocated(dev)}
    setup_s = time.perf_counter() - r.t0
    length = min(r.seconds, TRACE_SECONDS) if r.trace else r.seconds
    lat, outs = [], []
    with trace.profiled(r.trace) as prof:
        t0 = time.perf_counter()
        while True:
            ids = pool[len(lat) % (count - warm)]
            t = time.perf_counter()
            outs.append(pred.predict(ids))
            lat.append(time.perf_counter() - t)
            if time.perf_counter() - t0 >= length:
                break
        window_s = time.perf_counter() - t0
    peak = _peak(dev)
    done = len(lat)
    rng = np.random.default_rng(stream(r.seed, 3))
    pick = sorted(rng.choice(done, size=min(CHECKED_REQUESTS, done), replace=False))
    del pred
    _free(dev)

    gd = g.to(dev)
    rows = graph_rows(gd, cfg, False)
    want = reference.predict(gd, steps, model.clone(params0, dev),
                             [torch.from_numpy(pool[j % (count - warm)])
                              .long().to(dev) for j in pick], rows)
    numbers = check.predict_numbers([torch.from_numpy(outs[j]) for j in pick],
                                    want)
    r.info["numbers"] = numbers
    summary = trace.summarize(prof, window_s) if r.trace else None
    cnt = {}
    if r.trace:
        for j in range(done):
            ids = torch.from_numpy(pool[j % (count - warm)]).long().to(dev)
            for key, v in counts.exact_step(rows.indptr, rows.indices, ids,
                                            steps, int(config["feature_dim"]),
                                            False).items():
                cnt[key] = cnt.get(key, 0.0) + v
    r.info.update(window_s=window_s, requests=done, warmup_requests=i,
                  p50_first_last_ms=[1e3 * float(np.median(lat[:50])),
                                     1e3 * float(np.median(lat[-50:]))],
                  latency_ms={f"p{q}": 1e3 * float(np.percentile(lat, q))
                              for q in (50, 90, 95, 99, 100)})
    r.out.update(values={"predict_nodes_per_s": done * k / window_s,
                         "request_p95_ms": 1e3 * float(np.percentile(lat,
                                                                     95)),
                         "peak_mem_gib": peak / 2.0 ** 30,
                         "setup_s": setup_s},
                 readings=Readings(trace=summary, counts=cnt, memory=memory),
                 numbers=numbers, attempted=done, failed=0, peak=peak,
                 window_s=window_s)


KINDS = {"train": run_train, "predict": run_predict}


# ------------------------------ the result -------------------------------

def run(bench, cell_name: str, seed: int, seconds: float, trace_on: bool,
        device, t0: float, overrides: Optional[dict] = None) -> dict:
    """Run the cell ``cell_name`` once on ``device`` and return its result
    line (a dict).  ``overrides``: ``{"config": {...}, "traffic": {...}}``
    replacing keys of the cell's files (small sizes in the CPU tests)."""
    cell = bench.cell(cell_name)
    overrides = overrides or {}
    config = {**bench.config(cell.config), **overrides.get("config", {})}
    traffic = {**bench.traffic(cell.traffic), **overrides.get("traffic", {})}
    dev = torch.device(device)
    r = Run(bench, cell, config, traffic, int(seed), float(seconds),
            bool(trace_on), dev, t0)
    KINDS[traffic["kind"]](r)
    correct, checks = check.compare(r.out["numbers"],
                                    bench.limits(cell.name))
    metrics = {}
    if trace_on:
        for m in bench.per_layer(cell.name):
            v = load_reader(bench.metric_dir(m["name"]))(r.out["readings"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in bench.end_to_end(cell.name):
            metrics[m["name"]] = {"value": float(r.out["values"][m["name"]]),
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": int(r.out["peak"])}
    result = {"correct": bool(correct), "attempted": int(r.out["attempted"]),
              "failed": int(r.out["failed"]), "metrics": metrics,
              "device": device_info}
    summary = r.out["readings"].trace
    if trace_on and summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    _write_info(bench.root, cell.name, r)
    for k, c in checks.items():
        r.log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    result["checks"] = checks
    return result


def _write_info(root: Path, cell: str, r: Run) -> None:
    """The run's host-paced figures, on standard error and as a file under
    ``bench_out/`` in the checkout."""
    info = dict(r.info, seed=r.seed, trace=r.trace)
    r.log("info " + json.dumps(info))
    out = Path(root) / OUT_DIR
    out.mkdir(exist_ok=True)
    (out / f"{cell}.seed{r.seed}.trace{int(r.trace)}.json").write_text(
        json.dumps(info) + "\n")
