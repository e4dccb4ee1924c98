"""Rank-side checks of the data-parallel path.

Functions here run on every rank of a process group (start them with
:func:`.launch.spawn`): the CPU tests run them over gloo and chip_smoke.py
over NCCL on the card.  Each reads its inputs from, and rank 0 writes its
results to, ``.npz`` files, so the process that started the ranks (which
may hold other frameworks) compares them with its own references; the
halo primitives are checked here against plain gathers and scatters of the
whole tables and raise on a mismatch.  :func:`run_jobs` runs several of
them, one after another, in one group (one spawn for a whole test module).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import from_fields, parse_flags
from ..data.graph import PaddedGraph, shard_graph_rows, shard_table_rows
from ..data.loaders import load_data
from ..models import gcn as M
from ..models.aggregators import (full_neighborhood_mean,
                                  full_neighborhood_mean_halo)
from ..ops import cuda_spmm as K
from ..ops import layers as L
from ..ops.gather import row_gather
from ..sampler.scheduler import BatchFields, LayerSample
from ..training import step as St
from ..training.loop import Trainer
from . import halo
from . import mesh as PM
from .mesh import make_mesh, shard_rows, whole

# the transports move rows and do no arithmetic: exact.  The owner-routed
# contraction sums float32 partials in another order than one device.
CONTRACT_TOL = 1e-5


def _device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _fail(msg: str):
    raise AssertionError(f"rank {dist.get_rank()}: {msg}")


def _same(name: str, got: torch.Tensor, want: torch.Tensor,
          atol: float = 0.0) -> float:
    err = (got.float() - want.float()).abs().max().item() if got.numel() \
        else 0.0
    if got.shape != want.shape or not err <= atol:
        _fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
              f"max abs err {err}")
    return err


def _ids(gen: torch.Generator, rows: int, n: int, sentinel: int,
         dev) -> torch.Tensor:
    """Request ids with duplicates, sentinel ids and ids past the sentinel
    (parked), different on every rank."""
    ids = torch.randint(0, rows, (n,), generator=gen)
    ids[:n // 8] = ids[n // 8:n // 4]                    # duplicates
    ids[n // 4:n // 4 + 3] = sentinel                     # sentinel
    ids[n // 4 + 3:n // 4 + 5] = 1 << 30                  # parked
    return ids[torch.randperm(n, generator=gen)].to(torch.int32).to(dev)


def halo_primitives(seed: int = 0, rows_per_rank: int = 40, d: int = 12,
                    k: int = 6, n_req: int = 96) -> dict:
    """``row_gather`` (float32 and bfloat16, with its gradient),
    ``row_gather2``, ``row_scatter`` and ``owner_routed`` (the full term's
    contraction through ``hbm_gather_aggregate``) on this group's mesh,
    each against the plain operation on the whole table, which every rank
    builds from ``seed``.  Returns the largest error of each; raises on a
    mismatch."""
    mesh = make_mesh()
    dev = _device()
    p, q = mesh.size, mesh.rank
    rows = rows_per_rank * p
    sentinel = rows - 5
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(rows, d, generator=g)
    itable = torch.randint(0, 1 << 20, (rows, k), generator=g).to(
        torch.int32)
    ftable = torch.randn(rows, k, generator=g)
    g.manual_seed(seed + 1 + q)                # every rank its own requests
    ids = _ids(g, rows, n_req, sentinel, dev)
    table, itable, ftable = (t.to(dev) for t in (table, itable, ftable))
    local = mesh.local(table)
    errs = {}

    def plain(t, i):
        return row_gather(t, i, sentinel)

    for dtype in (torch.float32, torch.bfloat16):
        got = halo.row_gather(local.to(dtype), ids, mesh, sentinel)
        errs[f"row_gather {dtype}"] = _same(f"row_gather {dtype}", got,
                                            plain(table.to(dtype), ids))
    safe = torch.where(ids.long() < rows, ids, 0)      # no sentinel
    errs["row_gather all live"] = _same(
        "row_gather without a sentinel", halo.row_gather(local, safe, mesh),
        table[safe.long()])

    # the gradient: d sum(c * gathered) / d table, summed over the ranks'
    # requests, each owner keeping its block
    leaf = local.clone().requires_grad_()
    coef = torch.randn(n_req, d, generator=g).to(dev)
    (halo.row_gather(leaf, ids, mesh, sentinel) * coef).sum().backward()
    live = ids.long() < sentinel
    want = torch.zeros_like(table).index_add_(
        0, ids.long()[live], coef[live])
    want = whole(want, mesh).reshape(p, rows, d).sum(0)
    errs["row_gather grad"] = _same("row_gather gradient", leaf.grad,
                                    mesh.local(want), 1e-5)

    gi, gf = halo.row_gather2(mesh.local(itable), mesh.local(ftable), ids,
                              mesh, sentinel)
    errs["row_gather2 int"] = _same("row_gather2 int32", gi,
                                    plain(itable, ids))
    errs["row_gather2 float"] = _same("row_gather2 float32", gf,
                                      plain(ftable, ids))

    # scatter of unique ids (each rank a disjoint set) and sentinel ids
    perm = torch.randperm(sentinel, generator=torch.Generator().manual_seed(
        seed + 7))[:p * 16].reshape(p, 16)
    mine = torch.cat([perm[q], torch.tensor([sentinel, rows - 1])]).to(
        torch.int32).to(dev)
    new = torch.randn(mine.shape[0], d, generator=g).to(dev)
    target = local.clone()
    halo.row_scatter(target, mine, new, mesh, sentinel)
    every = whole(mine.long().reshape(1, -1), mesh).reshape(-1)
    rows_new = whole(new, mesh)
    keep = every < sentinel
    want = table.clone()
    want[every[keep]] = rows_new[keep]
    errs["row_scatter"] = _same("row_scatter", target, mesh.local(want))

    # the owner-routed contraction over this rank's 16 rows of neighbours
    f_loc = 16
    g.manual_seed(seed + 99 + q)
    nbr = torch.randint(0, sentinel + 1, (f_loc, k), generator=g).to(
        torch.int32).to(dev)
    w = torch.randn(f_loc, k, generator=g).to(dev)
    w[0] = 0.0                                     # an all-dead row
    for dtype in (torch.float32, torch.bfloat16):
        got = full_neighborhood_mean_halo(local.to(dtype), nbr, w, mesh)
        want = K.hbm_gather_aggregate_ref(table.to(dtype).float(), nbr, w)
        errs[f"owner_routed {dtype}"] = _same(
            f"owner_routed full term {dtype}", got, want, CONTRACT_TOL)
    return errs


def _save(path: str, arrays: dict) -> None:
    if dist.get_rank() == 0:
        np.savez(path, **arrays)


def full_term(npz_in: str, npz_out: str) -> None:
    """The owner-routed full term of the inputs in ``npz_in`` (``hist``
    [R, d], the padded graph's ``nbr`` / ``w`` / ``deg`` [N+1, ...],
    ``field`` [F]), with the history and the graph row-sharded; rank 0
    writes the whole ``[F, d]`` results to ``npz_out``, of the weights
    (``square0``) and of their squares (``square1``)."""
    mesh = make_mesh()
    dev = _device()
    z = np.load(npz_in)
    t = {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
    n = t["nbr"].shape[0] - 1
    graph = shard_graph_rows(PaddedGraph(t["nbr"], t["w"], t["deg"]), mesh,
                             shard_rows(n, mesh.size))
    hist = mesh.local(t["hist"])
    field = mesh.local(t["field"])
    out = {}
    for square in (False, True):
        got = full_neighborhood_mean(hist, graph, field, square=square,
                                     mesh=mesh)
        out[f"square{int(square)}"] = whole(got, mesh).cpu().numpy()
    _save(npz_out, out)


def shape_seeded_noise() -> None:
    """Replace the port's dropout masks and Gaussian noise with numpy draws
    seeded by the WHOLE tensor's shape (a rank takes its rows of them, and
    under tensor parallelism its columns), so a data-parallel run and
    another framework's single-program run of the same shapes draw the
    same noise."""

    def rng(shape, salt):
        return np.random.default_rng([salt, len(shape), *shape])

    def dropout(gen, x, keep_prob, block=None):
        if keep_prob >= 1.0:
            return x
        if hasattr(x, "val"):
            return x.replace(val=dropout(gen, x.val, keep_prob, block))
        shape = tuple(x.shape) if block is None \
            else (block[0], *(x.shape[1:] if len(block) == 2
                              else (block[2],)))
        keep = torch.from_numpy(rng(shape, 1).random(shape) < keep_prob)
        if block is not None:
            keep = keep.narrow(0, block[1], x.shape[0])
            if len(block) == 4:
                keep = keep.index_select(1, block[3].cpu())
        return torch.where(keep.to(x.device), x, 0.0) * (1.0 / keep_prob)

    def randn(shape, generator=None, device=None, dtype=None):
        del generator
        noise = rng(tuple(shape), 2).standard_normal(tuple(shape))
        return torch.from_numpy(noise.astype(np.float32)).to(
            device=device, dtype=dtype or torch.float32)

    L.dropout = dropout
    torch.randn = randn


def train_steps(npz_in: str, npz_out: str, fields: dict) -> None:
    """Train steps of the port's data-parallel step on prebuilt inputs:
    ``npz_in`` holds ``features`` and ``labels`` [N+1, ...], the padded
    train graph (``nbr``, ``w``, ``deg``), the params and histories
    (``param:<layer>/<name>``, ``hist:<l>/<j>``), and per step ``s`` its
    schedule (``s<s>:field<i>``, ``s<s>:pos<l>``, ``s<s>:w<l>``,
    ``s<s>:aw<l>``, ``s<s>:scales<l>``, and under the owner-aligned layout
    ``s<s>:self<l>``).  Dropout masks and noise are
    :func:`shape_seeded_noise`'s; ``fields`` are the configuration's.
    Rank 0 writes each step's loss and the final params, Adam first
    moments (``mu:<layer>/<name>``, a decaying sum of the gradients) and
    whole histories to ``npz_out``.  With ``tp > 1`` in ``fields`` each
    rank takes its columns of the params and histories, and the results
    are gathered whole."""
    shape_seeded_noise()
    cfg = from_fields(fields)
    mesh = make_mesh(cfg.shard_graph, tp=cfg.tp)
    dev = _device()
    z = np.load(npz_in)

    def T(key):
        return torch.from_numpy(z[key]).to(dev)
    n = z["nbr"].shape[0] - 1
    rows = shard_rows(n, mesh.size)
    graph = shard_graph_rows(PaddedGraph(T("nbr"), T("w"), T("deg")), mesh,
                             rows)
    feats, labels = (shard_table_rows(T(k), mesh, rows)
                     for k in ("features", "labels"))
    spec = M.build_model_spec(cfg, int(z["in_dim"]), labels.shape[1],
                              cfg.preprocess, cfg.cv, cfg.cvd)
    params = {}
    for key in z.files:
        if key.startswith("param:"):
            layer, name = key[6:].split("/")
            params.setdefault(layer, {})[name] = T(key)
    params = M.shard_param_tree(params, spec, mesh)
    hists = tuple(tuple(M.history_block(T(f"hist:{l}/{j}"), spec, l,
                                        mesh).clone()
                        for j in range(spec.n_history_per_layer))
                  for l in range(len(spec.history_dims))) if spec.cv else ()
    state = St.TrainState(params=params,
                          opt_state=St.make_optimizer(cfg).init(params),
                          histories=hists,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev))
    degrees = (cfg.degree,) * spec.num_agg_layers
    step = St.build_train_step(cfg, spec, degrees, n, mesh)
    out = {}
    for s in range(int(z["steps"])):
        layers = tuple(LayerSample(
            slot_pos=T(f"s{s}:pos{l}"), slot_w=T(f"s{s}:w{l}"),
            slot_aw=T(f"s{s}:aw{l}") if f"s{s}:aw{l}" in z.files else None,
            scales=T(f"s{s}:scales{l}"),
            self_pos=T(f"s{s}:self{l}") if f"s{s}:self{l}" in z.files
            else None) for l in range(spec.num_agg_layers))
        pack = BatchFields(
            fields=tuple(T(f"s{s}:field{i}")
                         for i in range(spec.num_agg_layers + 1)),
            layers=layers)
        state, m = step(state, graph, feats, labels, pack.fields[-1],
                        torch.Generator(device=dev), pack=pack)
        out[f"loss{s}"] = m["loss"].cpu().numpy()
    mu = M.gather_param_tree(state.opt_state.mu, spec, mesh)
    for layer, p in M.gather_param_tree(state.params, spec, mesh).items():
        for name, t in p.items():
            out[f"param:{layer}/{name}"] = t.cpu().numpy()
            out[f"mu:{layer}/{name}"] = mu[layer][name].cpu().numpy()
    for l, hl in enumerate(M.whole_histories(state.histories, spec, mesh)):
        for j, h in enumerate(hl):
            out[f"hist:{l}/{j}"] = h.float().cpu().numpy()
    _save(npz_out, out)


def run_jobs(jobs: list) -> None:
    """Run ``name(*args)`` for every ``(name, args)`` of ``jobs``, a
    function of this module each, in order, on every rank of one group."""
    for name, args in jobs:
        globals()[name](*args)


def trainer_runs(cases: dict, out: str, device: str = "cpu") -> None:
    """For every ``name: (flags, epochs)`` of ``cases``: a data-parallel
    ``Trainer`` from the flags (``--dp`` the group's size) trains
    ``epochs`` epochs, then evaluates the validation split and predicts
    the first 16 test ids; with ``--ckpt_dir`` set it also saves.  Rank 0
    writes ``<name>:losses``, ``<name>:eval`` (loss, accuracy, micro and
    macro F1), ``<name>:pred``, ``<name>:step0`` (the first step's loss
    and params, taken from a fresh Trainer) and ``<name>:probes`` (the
    activation moments of the train and the eval model and a
    gradient-variance table of 2 resamples, :func:`probes`) and
    ``<name>:tile`` (this rank's rows of the train graph's ``idx`` or
    ``nbr`` table, and its partition count) to ``out``."""
    res = {}
    for name, (flags, epochs) in cases.items():
        cfg = parse_flags(flags)
        ds = load_data(cfg)
        tr = Trainer(cfg, ds, device=device)
        first = _first_step(tr)
        tr = Trainer(cfg, ds, device=device)
        res[f"{name}:losses"] = np.array([tr.train_epoch()[0]
                                          for _ in range(epochs)])
        res[f"{name}:eval"] = np.array(tr.evaluate(ds.val_d)[:4])
        res[f"{name}:pred"] = tr.predict(ds.test_d[:16])
        res[f"{name}:step0"] = first
        res[f"{name}:probes"] = probes(tr)
        res[f"{name}:tile"] = np.array(
            [_graph_table(tr.graph_train).shape[0],
             getattr(tr.graph_train, "parts", 1)])
        if "--ckpt_dir" in flags:
            tr.save()
    _save(out, res)


def _graph_table(graph) -> torch.Tensor:
    return graph.idx if hasattr(graph, "idx") else graph.nbr


def epoch_steps(tr, epochs: int) -> np.ndarray:
    """``epochs`` epochs of ``tr``'s shuffled batches, as ``train_epoch``
    runs them (no lazy anchor, no ``--is_row_table``), returning every
    step's ``(loss, accuracy)`` (``train_epoch`` keeps the last)."""
    step = St.build_train_step(tr.cfg, tr.train_spec, tr.train_degrees,
                               tr.ds.num_data, tr.mesh)
    out = []
    for _ in range(epochs):
        tr.train_iter.shuffle()
        bm = torch.from_numpy(tr._epoch_matrix(
            tr.train_iter.data, tr.cfg.batch_size)).to(tr.device)
        for ids in bm:
            tr.state, m = step(tr.state, tr.graph_train, tr.train_features,
                               tr.labels, ids, tr.gen,
                               importance=tr.importance_train)
            out.append([float(m["loss"]), float(m["accuracy"])])
        tr._params_version += 1
    return np.array(out)


def state_arrays(tr, prefix: str) -> dict:
    """The whole (one-device layout) train state and eval histories of
    ``tr`` as ``{<prefix>:<leaf>: array}`` (every rank takes part).  The
    histories keep their node rows only: row N holds what sentinel field
    entries wrote, which one device writes and a mesh skips (both layouts
    mask every read of it)."""
    state, eval_h = tr._whole_state()
    out = {}
    trees = {"param": state.params, "mu": state.opt_state.mu,
             "nu": state.opt_state.nu, "avg": state.avg_params}
    for kind, tree in trees.items():
        for layer, p in (tree or {}).items():
            for name, t in p.items():
                out[f"{prefix}:{kind}:{layer}/{name}"] = \
                    t.detach().float().cpu().numpy()
    for kind, hs in (("hist", state.histories), ("eval_hist", eval_h)):
        for l, hl in enumerate(hs):
            for j, h in enumerate(hl):
                out[f"{prefix}:{kind}:{l}/{j}"] = \
                    h[:tr.ds.num_data].float().cpu().numpy()
    return out


def trainer_steps(cases: dict, out: str, device: str = "cpu") -> None:
    """For every ``name: (flags, epochs[, export])`` of ``cases`` (``--dp``
    and ``--tp`` whose product is the group's size): a Trainer trains
    ``epochs`` epochs step by step (:func:`epoch_steps`), then evaluates
    the validation split and predicts the first 16 test ids; with
    ``--ckpt_dir`` it also saves, and with an ``export`` path it exports
    its serving artifact there.  Rank 0 writes ``<name>:steps`` (every step's loss and
    accuracy), ``<name>:eval``, ``<name>:pred``, the whole state
    (:func:`state_arrays`, after the evaluation), ``<name>:local`` and
    ``<name>:head`` (the shapes of rank 0's blocks of the first and the
    last layer's weights) to ``out``."""
    from ..serving import export_predictor
    res = {}
    for name, (flags, epochs, *export) in cases.items():
        cfg = parse_flags(flags)
        ds = load_data(cfg)
        tr = Trainer(cfg, ds, device=device)
        first = M.first_param_layer(tr.train_spec)
        head = max(tr.state.params, key=lambda l: int(l[5:]))
        res[f"{name}:local"] = np.array(
            tr.state.params[first]["weights"].shape)
        res[f"{name}:head"] = np.array(
            tr.state.params[head]["weights"].shape)
        res[f"{name}:steps"] = epoch_steps(tr, epochs)
        res[f"{name}:eval"] = np.array(tr.evaluate(ds.val_d)[:4])
        res[f"{name}:pred"] = tr.predict(ds.test_d[:16])
        res.update(state_arrays(tr, name))
        if "--ckpt_dir" in flags:
            tr.save()
        if export:
            export_predictor(tr, export[0])
    _save(out, res)


def save_runs(cases: dict, out: str) -> None:
    """For every ``name: flags`` of ``cases``: a Trainer of ``flags``
    trains one epoch and saves.  Rank 0 writes ``<name>`` (whether the
    Trainer built a background writer, and whether the file was on disk
    when ``save()`` returned) to ``out``."""
    res = {}
    for name, flags in cases.items():
        cfg = parse_flags(flags)
        tr = Trainer(cfg, load_data(cfg), device=_device())
        tr.train_epoch()
        path = tr.save()
        if dist.get_rank() == 0:
            res[name] = np.array([tr._async_ckpt is not None,
                                  os.path.exists(path)])
    _save(out, res)


def load_run(flags: list, out: str) -> None:
    """A Trainer of ``flags`` loads ``--ckpt_dir``'s checkpoint (histories
    too) and predicts the first 16 test ids; rank 0 writes them to
    ``out`` (``pred``)."""
    cfg = parse_flags(flags)
    ds = load_data(cfg)
    tr = Trainer(cfg, ds, device=_device())
    tr.load(load_history=True)
    _save(out, {"pred": tr.predict(ds.test_d[:16])})


def schedules(flags: list, out_dir: str, steps: int = 3) -> None:
    """Every rank writes the train schedules of the first ``steps`` batches
    of a Trainer of ``flags`` to ``<out_dir>/sched<global rank>.npz``
    (fields and slots of every layer), drawn as the train step draws
    them."""
    cfg = parse_flags(flags)
    tr = Trainer(cfg, load_data(cfg), device=_device())
    bm = torch.from_numpy(tr._epoch_matrix(
        tr.train_iter.data, cfg.batch_size)).to(tr.device)
    arrays = {}
    for s, ids in enumerate(bm[:steps]):
        pack = St._schedule(cfg, tr.train_spec, tr.train_degrees,
                            tr.graph_train, ids, tr.gen, None,
                            train_mode=True, mesh=tr.mesh)
        for i, f in enumerate(pack.fields):
            arrays[f"s{s}:field{i}"] = f.cpu().numpy()
        for l, ls in enumerate(pack.layers):
            arrays[f"s{s}:pos{l}"] = ls.slot_pos.cpu().numpy()
            arrays[f"s{s}:w{l}"] = ls.slot_w.cpu().numpy()
    np.savez(f"{out_dir}/sched{dist.get_rank()}.npz", **arrays)


def cli_in_group(argv: list, out_dir: str) -> None:
    """``cli/train.py``'s ``main(argv)`` as one rank of this group (the
    way torchrun starts it), its standard output to
    ``<out_dir>/cli<global rank>.txt``."""
    import contextlib
    from ..cli import train as train_cli
    with open(f"{out_dir}/cli{dist.get_rank()}.txt", "w") as f, \
            contextlib.redirect_stdout(f):
        train_cli.main(argv)


def export_run(flags: list, path: str, epochs: int) -> None:
    """A data-parallel Trainer from ``flags`` trains ``epochs`` epochs and
    exports its serving artifact to ``path`` (every rank takes part in
    the gathers; rank 0 writes)."""
    from ..serving import export_predictor
    cfg = parse_flags(flags)
    ds = load_data(cfg)
    tr = Trainer(cfg, ds, device=_device())
    for _ in range(epochs):
        tr.train_epoch()
    export_predictor(tr, path)


def probes(tr) -> np.ndarray:
    """``tr``'s activation moments (train and eval model, every tap) and a
    gradient-variance table of 2 resamples, flattened in a fixed order."""
    out = []
    for train in (True, False):
        stats = tr.activation_stats(train=train)
        out += [v for label in sorted(stats) for v in (
            stats[label]["mean"], stats[label]["std"], stats[label]["absmax"])]
    gv = tr.gradient_variance(times=2, log=lambda *a: None)
    return np.array(out + [gv[k] for k in sorted(gv)], np.float64)


def _first_step(tr) -> np.ndarray:
    """The first train step's loss and params, flattened."""
    bm = torch.from_numpy(tr._batch_matrix(
        tr.train_iter.data[:tr.cfg.batch_size], tr.cfg.batch_size,
        tr.ds.num_data)).to(tr.device)
    step = St.build_train_step(tr.cfg, tr.train_spec, tr.train_degrees,
                               tr.ds.num_data, tr.mesh)
    state, m = step(tr.state, tr.graph_train, tr.train_features, tr.labels,
                    bm[0], tr.gen, importance=tr.importance_train)
    flat = [m["loss"].reshape(1).cpu()] + [
        state.params[l][n].reshape(-1).cpu()
        for l, n in St.param_keys(state.params)]
    return torch.cat(flat).numpy()


def host_run(flags: list, out: str, device: str = "cpu") -> None:
    """One rank of a (possibly multi-host) data-parallel run of ``flags``:
    a Trainer trains ``--epochs`` epochs, evaluates the validation split,
    predicts the first 16 test ids and saves to ``--ckpt_dir``; then a
    fresh Trainer loads the checkpoint (histories too) and predicts them
    again.  The first rank of each host writes ``<out>/host<i>.npz``
    (``losses``, ``eval``, ``pred``, ``pred_loaded``, ``ranks``: the
    group's size and this host's first rank; ``wire``: this rank's
    collective bytes of the training epochs, all and across hosts)."""
    cfg = parse_flags(flags)
    ds = load_data(cfg)
    tr = Trainer(cfg, ds, device=device)
    PM.reset_wire()
    res = {"losses": np.array([tr.train_epoch()[0]
                               for _ in range(cfg.epochs)])}
    res["wire"] = np.array([sum(PM.WIRE.values()),
                            sum(PM.WIRE_CROSS_HOST.values())])
    res.update(eval=np.array(tr.evaluate(ds.val_d)[:4]),
               pred=tr.predict(ds.test_d[:16]))
    tr.save()
    again = Trainer(cfg, ds, device=device)
    again.load(load_history=True)
    res["pred_loaded"] = again.predict(ds.test_d[:16])
    rank, world = dist.get_rank(), dist.get_world_size()
    host = tr.mesh.host(tr.mesh.rank)
    res["ranks"] = np.array([world, rank])
    if rank == host * (world // tr.mesh.hosts):
        np.savez(f"{out}/host{host}.npz", **res)
    dist.barrier()


def main(argv=None) -> None:
    """``python -m stochastic_gcn_tpu_torch.parallel.checks OUT DEVICE
    FLAGS...``: :func:`host_run` of ``FLAGS`` on every rank, started the
    way the command-line entry points start theirs
    (``launch.dispatch``): ``--dp P`` spawns ``P`` local ranks;
    ``--coordinator host:port --num_processes H --process_id i`` (run once
    per host) spawns this host's ``P / H``."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    out, device, flags = argv[0], argv[1], argv[2:]
    from . import launch
    if launch.dispatch(parse_flags(flags), device,
                       "stochastic_gcn_tpu_torch.parallel.checks", argv):
        return
    host_run(flags, out, device)


def mesh_hosts(hosts: int, out: str) -> None:
    """``make_mesh(hosts=hosts)`` on this group; rank 0 writes the error
    it raised (empty when none) to ``out``."""
    try:
        make_mesh(hosts=hosts)
        msg = ""
    except ValueError as e:
        msg = str(e)
    _save(out, {"error": np.array(msg)})


def fail_on_rank_zero() -> None:
    """Rank 0 raises while the other ranks wait in a collective it never
    joins: the spawn must fail at once, not when the group's timeout
    ends."""
    if dist.get_rank() == 0:
        raise RuntimeError("rank 0 fails on purpose")
    dist.barrier()


if __name__ == "__main__":
    main()
