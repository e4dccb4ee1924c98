"""NeighbourMLP baseline: an MLP over precomputed multi-hop features.

Port of stochastic_gcn_tpu/models/mlp.py: the features are
``hstack(X, ÂX, Â²X, ..., Â^num_layers X)``, built once on the host, then a
``num_fc_layers``-deep MLP with dropout before each dense layer.  No graph
sampling at train time: a batch slices rows of the precomputed features,
the degenerate all-preprocessed point of the estimator family.  Sparse
features are densified, whatever ``--dense_input`` says, as the JAX
trainer does.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..data.graph import dense_rows
from ..ops import layers as L
from ..training.step import make_optimizer, param_keys
from ..utils.metrics import calc_f1
from .gcn import masked_loss_and_accuracy


def multihop_features(feats, adj, num_hops: int):
    """hstack(X, ÂX, ..., Â^num_hops X)."""
    out = [feats]
    for _ in range(num_hops):
        out.append(adj.dot(out[-1]))
    if sp.issparse(feats):
        return sp.hstack(out).tocsr()
    return np.hstack([np.asarray(x) for x in out])


def build_mlp_spec(cfg, input_dim: int, output_dim: int):
    """``(name, input dim, output dim, relu, layer norm)`` of each of the
    ``num_fc_layers`` dense layers: ``hidden1`` wide, the last one linear
    and without norm."""
    dims = []
    n = cfg.num_fc_layers
    for l in range(n):
        last = l + 1 == n
        dims.append((f"dense{l}", input_dim if l == 0 else cfg.hidden1,
                     output_dim if last else cfg.hidden1, not last,
                     cfg.layer_norm and not last))
    return tuple(dims)


def init_mlp_params(gen: torch.Generator, spec) -> dict:
    """Glorot weights (zero offset, unit scale) on ``gen``'s device."""
    return {name: L.init_dense(gen, in_dim, out_dim, norm)
            for name, in_dim, out_dim, _relu, norm in spec}


def mlp_forward(params: dict, spec, x: torch.Tensor, gen: torch.Generator,
                keep_prob: float, train: bool) -> torch.Tensor:
    """Logits: dropout (training only), then each dense layer."""
    kp = keep_prob if train else 1.0
    h = x
    for name, _in, _out, relu, norm in spec:
        h = L.dropout(gen, h, kp)
        h = L.dense(params[name], h, L.relu if relu else L.identity, norm)
    return h


def _loss(params: dict, spec, logits, y, valid, weight_decay: float,
          multitask: bool):
    """(loss, accuracy) over the valid rows, plus L2 (sum(w^2)/2) on the
    first dense layer's weights only: the reference's Dense registers no
    layer-norm variables."""
    l2 = params[spec[0][0]]["weights"].square().sum() / 2.0
    return masked_loss_and_accuracy(weight_decay * l2, logits, y, valid,
                                    multitask)


class MLPTrainer:
    """Trainer for ``--model mlp``: the multi-hop features, labels, params
    and Adam state live on ``device``; batches slice feature rows.  The
    epoch order comes from a numpy generator seeded by ``cfg.seed``,
    dropout from a ``torch.Generator`` on the device.  ``device="cuda"``
    on a machine without CUDA raises.  It runs on one device whatever
    ``cfg.dp`` and ``cfg.tp`` say, as the JAX trainer does."""

    def __init__(self, cfg, ds, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MLPTrainer(device='cuda') but CUDA is not "
                               "available")
        self.cfg, self.ds, self.device = cfg, ds, device
        n = ds.num_data
        feats_mh = multihop_features(ds.feats, ds.full_adj, cfg.num_layers)
        self.features = dense_rows(feats_mh, n, device=device)
        self.labels = dense_rows(ds.labels, n, device=device)
        self.spec = build_mlp_spec(cfg, feats_mh.shape[1], ds.num_classes)
        self.params = {l: {k: t.to(device) for k, t in p.items()}
                       for l, p in init_mlp_params(torch.Generator()
                                                   .manual_seed(cfg.seed),
                                                   self.spec).items()}
        self.tx = make_optimizer(cfg)
        self.opt_state = self.tx.init(self.params)
        self.gen = torch.Generator(device=device).manual_seed(cfg.seed)
        self.rng = np.random.default_rng(cfg.seed)

    def _batch(self, ids, size: int) -> torch.Tensor:
        """``ids`` sentinel-padded to ``size``, on the device."""
        out = np.full(size, self.ds.num_data, np.int32)
        out[:len(ids)] = ids
        return torch.from_numpy(out).to(self.device)

    def _inputs(self, batch: torch.Tensor):
        ids = batch.to(torch.int64)
        return (self.features.index_select(0, ids),
                self.labels.index_select(0, ids),
                (batch < self.ds.num_data).float())

    def train_step(self, batch: torch.Tensor):
        """One Adam step on the batch ``[B]`` (sentinel-padded ids);
        returns its (loss, accuracy) as device scalars."""
        cfg = self.cfg
        x, y, valid = self._inputs(batch)
        keys = param_keys(self.params)
        params = {l: {k: t.detach().requires_grad_() for k, t in p.items()}
                  for l, p in self.params.items()}
        logits = mlp_forward(params, self.spec, x, self.gen, cfg.keep_prob,
                             True)
        loss, acc = _loss(params, self.spec, logits, y, valid,
                          cfg.weight_decay, cfg.multitask)
        flat = torch.autograd.grad(loss, [params[l][k] for l, k in keys])
        grads: dict = {}
        for (l, k), g in zip(keys, flat):
            grads.setdefault(l, {})[k] = g
        self.tx.update(grads, self.opt_state, self.params)
        return loss.detach(), acc.detach()

    @torch.no_grad()
    def eval_step(self, batch: torch.Tensor):
        """(loss, accuracy, class probabilities ``[B, C]``) of a batch,
        without dropout."""
        cfg = self.cfg
        x, y, valid = self._inputs(batch)
        logits = mlp_forward(self.params, self.spec, x, self.gen,
                             cfg.keep_prob, False)
        loss, acc = _loss(self.params, self.spec, logits, y, valid,
                          cfg.weight_decay, cfg.multitask)
        pred = torch.sigmoid(logits) if cfg.multitask \
            else torch.softmax(logits, dim=1)
        return loss, acc, pred

    def train_epoch(self):
        """One epoch over the shuffled train ids; returns the last batch's
        (loss, accuracy).  The device is waited for once, at the end."""
        bs = self.cfg.batch_size
        ids = np.array(self.ds.train_d, np.int32)
        self.rng.shuffle(ids)
        loss = acc = torch.zeros(())
        for s in range(0, len(ids), bs):
            loss, acc = self.train_step(self._batch(ids[s:s + bs], bs))
        return float(loss), float(acc)

    def evaluate(self, data_ids):
        """(loss, accuracy, micro F1, macro F1) over ``data_ids``."""
        bs = self.cfg.test_batch_size
        data_ids = np.asarray(data_ids, np.int32)
        preds, tot_loss, tot_acc = [], 0.0, 0.0
        for s in range(0, len(data_ids), bs):
            chunk = data_ids[s:s + bs]
            loss, acc, pred = self.eval_step(self._batch(chunk, bs))
            tot_loss = tot_loss + loss * len(chunk)
            tot_acc = tot_acc + acc * len(chunk)
            preds.append(pred[:len(chunk)])
        micro, macro = calc_f1(torch.cat(preds).cpu().numpy(),
                               self.ds.labels[data_ids], self.cfg.multitask)
        return (float(tot_loss) / len(data_ids),
                float(tot_acc) / len(data_ids), micro, macro)
