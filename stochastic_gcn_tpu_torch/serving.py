"""Serving artifacts: export a trained model, serve predictions from it.

Port of stochastic_gcn_tpu/serving.py::

    art = export_predictor(trainer, "model.export")      # after training
    ...
    pred = load_predictor("model.export", device="cuda")  # serving side
    probs = pred.predict([3, 17, 42])                     # [3, C] float32

An artifact is a directory of two files, in the JAX package's layout where
a torch artifact can keep it:

* ``state.npz``: the eval params (the Polyak average when one is kept), the
  converged eval histories, the eval graph (``graph/nbr``, ``w``, ``deg``
  padded; ``graph/bstart``, ``idx``, ``w``, ``deg``, ``renorm`` edge-list),
  the test features (dense, or
  ``idx`` / ``val`` when padded-sparse), the labels and the importance
  table, named as ``manifest["names"]`` lists them; ``bfloat16`` arrays
  are stored as their ``uint16`` bit view under the ``"bf16:"`` prefix, as
  the JAX package stores them, and ``id_map`` where the trainer relabelled
  its nodes.  Written uncompressed: the features of a large graph are GBs
  of incompressible floats, which zlib would spend minutes on.
* ``manifest.json``: the JAX manifest's ``num_nodes``, ``num_classes``,
  ``batch_size``, ``scan_batches``, ``multitask`` and ``names``, with
  ``torch_version`` in place of ``jax_version``; the sampling ``seed``, the
  requested ``platforms``, and what the model is rebuilt from: the serving
  ``config`` (every ``Config`` field), the raw ``feature_dim``, whether the
  first layer takes ``sparse_input``, the features' sparse width, and the
  eval graph's layout (``graph_format``) and statics (``graph_statics``:
  the tier split; an edge-list graph's degree, budget, truncation and
  ``parts``: a node-sharded edge list is stored whole in its partitioned
  layout, which one process serves as it is).

The one intended difference: the JAX artifact also holds ``module.shlo``,
the serialised eval program, which any JAX runtime can call without the
package.  The port's kernels are bound through ``ctypes``
(``ops/_build.py``), so no program that calls them can be serialised.  The
:class:`Predictor` rebuilds the eval epoch from this package's
``models/gcn.py`` and ``training/step.py::build_eval_epoch`` instead, so
serving needs the port installed.

Contract, as in the JAX package:

* Export after the CV histories have converged under the final weights
  (``export_predictor`` runs ``Trainer.predict``'s refresh first).  At the
  CV fixed point a prediction is exact inference and does not depend on
  the sampled neighbours.
* A request never changes the artifact: every device call starts from the
  stored histories (the eval epoch's refreshed rows are dropped, as the
  JAX Predictor drops the exported call's new histories) and from a
  generator seeded with the manifest's seed, so the same ids give bitwise
  equal answers in any order of requests.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Sequence

import numpy as np
import torch

from .config import from_fields
from .data.graph import FlatGraph, PaddedGraph, PaddedSparseFeatures
from .models import gcn as M
from .parallel.mesh import whole
from .training import step as S

_STATE = "state.npz"
_MANIFEST = "manifest.json"
_BF16 = "bf16:"          # npz has no bfloat16: the uint16 bit view


def _serving_tensors(trainer) -> dict:
    """The tensors a Predictor serves from, by artifact name: whole tables
    (a data-parallel trainer's row blocks gathered from every rank, the
    node tables cut back to their ``N+1`` rows; a tensor-parallel
    trainer's column blocks of the params and histories gathered from its
    model group)."""
    mesh = getattr(trainer, "mesh", None)
    n1 = trainer.ds.num_data + 1

    def node_table(t):
        if mesh is None or not mesh.shard_graph:
            return t
        return whole(t, mesh)[:n1]

    out = {f"params/{layer}/{name}": t
           for layer, p in M.gather_param_tree(
               trainer._eval_params(), trainer.train_spec, mesh).items()
           for name, t in p.items()}
    eval_h = M.whole_histories(trainer.eval_histories, trainer.test_spec,
                               mesh)
    for l, hl in enumerate(eval_h):
        for j, h in enumerate(hl):
            out[f"histories/{l}/{j}"] = h
    g = trainer.graph_full

    def graph_table(name):
        t = getattr(g, name)
        if not g.sharded or name in ("bstart", "deg", "renorm"):
            return t
        # a node-sharded edge list's tiles, whole, keep its parts layout
        return whole(t, mesh) if isinstance(g, FlatGraph) else node_table(t)
    out.update({f"graph/{name}": graph_table(name)
                for name in _GRAPH_FIELDS[type(g)][0]})
    feats = trainer.test_features
    if isinstance(feats, PaddedSparseFeatures):
        out.update({"features/idx": node_table(feats.idx),
                    "features/val": node_table(feats.val)})
    else:
        out["features"] = node_table(feats)
    out["labels"] = node_table(trainer.labels)
    out["importance"] = trainer.importance_test
    return out


# per graph layout: its tensor fields, stored as graph/<name>, and its
# static fields, stored in the manifest's graph_statics
_GRAPH_FIELDS = {
    PaddedGraph: (("nbr", "w", "deg"), ("tier_w", "tier_frac")),
    FlatGraph: (("bstart", "idx", "w", "deg", "renorm"),
                ("max_degree", "edge_cap_per_row", "parts", "tier_w",
                 "tier_frac", "truncated_frac")),
}
_LAYOUTS = {"padded": PaddedGraph, "edgelist": FlatGraph}


def _to_numpy(t: torch.Tensor):
    """(npz key prefix, host array): bfloat16 as its uint16 bit view."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return _BF16, t.view(torch.int16).numpy().view(np.uint16)
    return "", t.numpy()


def _from_numpy(key: str, a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if key.startswith(_BF16):
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device)


def export_predictor(trainer, path: str, refresh: bool = True,
                     platforms: Sequence[str] = (),
                     scan_batches: int = 1) -> str:
    """Write ``trainer``'s serving surface to the directory ``path``.

    Refreshes the CV eval histories under the current weights first (with
    ``refresh`` and ``test_cv``), then writes the eval weights (the Polyak
    average when one is kept), histories, graph, features, labels and
    importance table, and the manifest.  A request is served in device
    calls of ``scan_batches`` x ``cfg.test_batch_size`` ids.  ``platforms``
    is recorded and has no effect: the device is chosen at load."""
    cfg = trainer.cfg
    n = trainer.ds.num_data
    # serving is faithful only where the eval config is deterministic: CV
    # at its fixed point, or a test degree that takes every neighbour
    if not cfg.test_cv and cfg.test_degree < trainer.graph_full.pad_degree:
        warnings.warn(
            "exporting a SAMPLED eval config (test_cv off, test_degree "
            f"{cfg.test_degree} < max degree): the artifact freezes one "
            "neighbor sample per node forever and will diverge from live "
            "Trainer.predict; use --test_cv or a covering --test_degree "
            "for deterministic serving.", stacklevel=2)
    if refresh and cfg.test_cv:
        trainer.predict(np.zeros((1,), np.int64), refresh=True)

    tensors = _serving_tensors(trainer)
    mesh = getattr(trainer, "mesh", None)
    if mesh is not None:
        # every rank took part in the gathers; global rank 0 writes
        if mesh.global_rank == 0:
            _write_artifact(trainer, path, tensors, platforms, scan_batches)
        torch.distributed.barrier()
        return path
    return _write_artifact(trainer, path, tensors, platforms, scan_batches)


def _write_artifact(trainer, path, tensors, platforms, scan_batches) -> str:
    cfg = trainer.cfg
    n = trainer.ds.num_data
    arrays = {}
    names = []
    for name, t in tensors.items():
        prefix, a = _to_numpy(t)
        arrays[prefix + name] = a
        names.append(name)
    id_map = getattr(trainer, "_id_to_internal", None)
    if id_map is not None:
        arrays["id_map"] = np.asarray(id_map, np.int32)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _STATE), "wb") as f:
        np.savez(f, **arrays)
    feats = trainer.test_features
    g = trainer.graph_full
    manifest = {"num_nodes": int(n),
                "num_classes": int(trainer.ds.num_classes),
                "batch_size": int(cfg.test_batch_size),
                "scan_batches": int(max(1, scan_batches)),
                "multitask": bool(cfg.multitask),
                "names": names,
                "torch_version": torch.__version__,
                "seed": int(cfg.seed),
                "platforms": list(platforms),
                "feature_dim": int(trainer.ds.feature_dim),
                "sparse_input": bool(any(
                    getattr(s, "sparse_inputs", False)
                    for s in trainer.test_spec.specs)),
                "sparse_dim": int(feats.dim)
                if isinstance(feats, PaddedSparseFeatures) else None,
                "graph_format": ("edgelist" if isinstance(g, FlatGraph)
                                 else "padded"),
                "graph_statics": {k: getattr(g, k)
                                  for k in _GRAPH_FIELDS[type(g)][1]},
                "config": dataclasses.asdict(cfg)}
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


class Predictor:
    """Serving-side handle over an exported artifact, on ``device``: the
    eval epoch of the manifest's config over the stored state.
    ``device="cuda"`` without CUDA raises."""

    def __init__(self, path: str, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor(device='cuda') but CUDA is not "
                               "available")
        self.device = device
        with open(os.path.join(path, _MANIFEST)) as f:
            m = json.load(f)
        self.manifest = m
        self.num_nodes = m["num_nodes"]
        self.num_classes = m["num_classes"]
        self.batch_size = m["batch_size"]
        self.scan_batches = m["scan_batches"]
        self.multitask = m["multitask"]
        self.seed = m["seed"]
        with np.load(os.path.join(path, _STATE)) as z:
            raw = {k: z[k] for k in z.files}
        id_map = raw.pop("id_map", None)
        self._id_map = None if id_map is None else id_map.astype(np.int64)
        state = {k[len(_BF16):] if k.startswith(_BF16) else k:
                 _from_numpy(k, v, device) for k, v in raw.items()}

        cfg = from_fields(m["config"])
        spec = M.build_model_spec(
            cfg.replace(importance=cfg.test_importance), m["feature_dim"],
            self.num_classes, cfg.test_preprocess, cfg.test_cv,
            cfg.test_cvd, m["sparse_input"])
        n = self.num_nodes
        self._epoch = S.build_eval_epoch(
            cfg, spec, tuple([cfg.test_degree] * spec.num_agg_layers), n,
            with_preds=True)
        params: dict = {}
        for name, t in state.items():
            if name.startswith("params/"):
                _, layer, pname = name.split("/")
                params.setdefault(layer, {})[pname] = t
        self._params = params
        self._histories = tuple(
            tuple(state[f"histories/{l}/{j}"]
                  for j in range(spec.n_history_per_layer))
            for l in range(len(spec.history_dims) if spec.cv else 0))
        layout = _LAYOUTS[m["graph_format"]]
        self._graph = layout(**{name: state[f"graph/{name}"]
                                for name in _GRAPH_FIELDS[layout][0]},
                             **m["graph_statics"])
        self._features = PaddedSparseFeatures(
            idx=state["features/idx"], val=state["features/val"],
            dim=m["sparse_dim"]) if "features/idx" in state \
            else state["features"]
        self._labels = state["labels"]
        self._importance = state["importance"]

    @torch.no_grad()
    def _call(self, bm: np.ndarray):
        """One device call over the ``[scan_batches, B]`` batch matrix from
        the stored state: fresh copies of the histories, a generator seeded
        with the manifest's seed.  Returns host (preds, fields)."""
        hist = tuple(tuple(h.clone() for h in hl) for hl in self._histories)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        _, out = self._epoch(self._params, hist, self._graph,
                             self._features, self._labels,
                             torch.from_numpy(bm).to(self.device), gen,
                             self._importance)
        return (out["preds"].reshape(-1, self.num_classes).cpu().numpy(),
                out["fields"].reshape(-1).cpu().numpy())

    def predict(self, data_ids: Sequence[int]) -> np.ndarray:
        """[len(ids), C] float32 class probabilities in the caller's id
        order.  The ids go in chunks of ``scan_batches`` x ``batch_size``,
        each padded with the sentinel id; every predicted row is written to
        its node from the returned fields."""
        ids = np.asarray(data_ids, np.int64)
        internal = (self._id_map[ids] if self._id_map is not None
                    else ids).astype(np.int32)
        n, b = self.num_nodes, self.batch_size
        span = self.scan_batches * b
        # rows by node id, over the request's own ids only: a fresh [N+1, C]
        # table (the JAX Predictor's) costs milliseconds of page faults at
        # Reddit's size
        nodes, at = np.unique(internal, return_inverse=True)
        by_node = np.zeros((len(nodes), self.num_classes), np.float32)
        for lo in range(0, len(internal), span):
            chunk = internal[lo:lo + span]
            bm = np.full((span,), n, np.int32)
            bm[:len(chunk)] = chunk
            preds, fields = self._call(bm.reshape(self.scan_batches, b))
            valid = fields < n
            by_node[np.searchsorted(nodes, fields[valid])] = preds[valid]
        return by_node[at.reshape(-1)]


def load_predictor(path: str, device="cuda") -> Predictor:
    return Predictor(path, device=device)
