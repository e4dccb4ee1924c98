"""Configuration of the port: its own copy of the JAX package's flag dataclass.

Field names, defaults, derived properties and flag spellings are those of
stochastic_gcn_tpu/config.py (which mirror the reference's gcn/train.py
flags), so ``cli/train.py`` and ``cli/infer.py`` take the same command
lines and checkpoints carry the same config fields in both packages.  The
port imports nothing of the JAX package; tests/test_torch_config.py holds
the two definitions against each other.

Many options configure parts that are not ported yet (the trainer refuses
them, training/loop.py::_refuse_unported) or name JAX-only mechanisms
(``sched_prepass``, ``scan_unroll``, ``use_pallas``: accepted, no effect;
``use_pallas`` with ``--graph_format edgelist`` raises, as in JAX).
They stay so that one command line drives both packages.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence


@dataclass(frozen=True)
class Config:
    """All training and evaluation options (immutable, hashable)."""

    # -- core experiment flags --
    dataset: str = "cora"
    model: str = "graphsage"          # 'graphsage' | 'mlp'
    learning_rate: float = 0.01
    epochs: int = 200                 # min number of epochs to train
    data: int = 0                     # max amount of visited data (edge budget)
    hidden1: int = 32
    dropout: float = 0.5              # dropout RATE (keep_prob = 1 - dropout)
    dense_input: bool = False
    weight_decay: float = 5e-4
    early_stopping: int = 10

    # -- sampling --
    degree: int = 20                  # per-layer neighbour fanout
    batch_size: int = 1000
    cv: bool = False                  # control variate
    preprocess: bool = True           # PP: precompute the first aggregation
    test_batch_size: int = 1000
    test_degree: int = 20
    test_cv: bool = False
    test_preprocess: bool = True

    # -- architecture --
    num_layers: int = 2
    num_fc_layers: int = 1
    beta1: float = 0.9
    beta2: float = 0.999
    normalization: str = "gcn"        # 'gcn' | 'graphsage'
    layer_norm: bool = False
    polyak_decay: float = 0.0

    # -- estimator variants --
    load: bool = False
    det_dropout: bool = False
    cvd: bool = False
    test_cvd: bool = False
    importance: bool = False
    test_importance: bool = False

    # -- misc --
    seed: int = 1
    max_degree: int = -1              # cap graph degree at load
    gradvar: bool = False
    reverse: bool = False             # dropout after dense instead of before
    pp_nbr: bool = True               # PP uses neighbour features

    # -- additions over the reference's flags --
    # degree cap of the device-resident padded adjacency; -1 = the graph's
    # true max degree (exact)
    pad_degree: int = -1
    data_dir: str = "data"
    # storage dtype of the CV train histories ('bfloat16' | 'float32'); the
    # CV estimator stays unbiased for any stored h-bar
    history_dtype: str = "bfloat16"
    # eval histories stay float32 so CV inference converges to exactly the
    # exact prediction after num_layers + 1 passes
    test_history_dtype: str = "float32"
    features_dtype: str = "float32"
    # importance sampling
    is_approx_topk: bool = True
    is_recall_target: float = 0.95
    is_row_table: bool = False
    is_slot_cap: int = -1
    # dedup-compact each receptive field; default is the append-only layout
    field_dedup: bool = False
    sched_prepass: str = "auto"
    sched_prepass_budget_mb: int = 256
    sched_prepass_chunk: int = 32
    # multi-device layout
    dp: int = 1
    tp: int = 1
    dp_hosts: int = 1
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = 0
    halo_exchange: bool = True
    shard_graph: bool = True
    scatter_cap_mult: float = 2.0
    gather_cap_mult: float = 0.0
    owner_batching: bool = False
    partition_nodes: str = "none"
    use_pallas: bool = False
    feat_nnz_cap: int = 1024          # padded nnz/row cap of sparse features
    graph_format: str = "padded"      # 'padded' | 'edgelist'
    fadj_edge_mult: float = 0.0
    # two-tier full-neighbourhood contraction
    fadj_tier: bool = True
    fadj_tier_w: int = 0
    lazy_fullterm: bool = False       # epoch-frozen CV anchor
    scan_unroll: int = 1
    # checkpoints
    ckpt_dir: str = "tmp"
    ckpt_every: int = 0               # 0 = only at the end
    ckpt_compress: bool = True
    ckpt_async: bool = False
    # continue an interrupted run from ckpt_dir's checkpoint (fresh start
    # when there is none); --load restores weights and skips training
    resume: bool = False
    # write a profiler trace of the selected (1-based, comma-separated)
    # train epochs to this directory; empty = off
    profile_dir: str = ""
    profile_epochs: str = "2"

    # -------- derived properties --------
    @property
    def multitask(self) -> bool:
        return self.dataset == "ppi"

    @property
    def train_L(self) -> int:
        """Number of sampled aggregation layers at train time."""
        return self.num_layers - 1 if self.preprocess else self.num_layers

    @property
    def test_L(self) -> int:
        return self.num_layers - 1 if self.test_preprocess else self.num_layers

    @property
    def keep_prob(self) -> float:
        return 1.0 - self.dropout

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def from_fields(fields: Mapping[str, Any]) -> Config:
    """A ``Config`` from a mapping of field names to values, e.g.
    ``dataclasses.asdict`` of the JAX package's ``Config`` or the fields a
    checkpoint stores.  An unknown name raises, so that an option one
    package has and the other lacks cannot be dropped silently."""
    known = {f.name for f in dataclasses.fields(Config)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"not fields of Config: {unknown}")
    return Config(**fields)


def _add_bool_flag(parser: argparse.ArgumentParser, name: str,
                   default: bool) -> None:
    """TF1-style bool flags: --flag / --noflag / --flag=True|False."""

    class _BoolAction(argparse.Action):
        def __call__(self, p, ns, values, option_string=None):
            if option_string.startswith("--no"):
                setattr(ns, name, False)
            elif values is None:
                setattr(ns, name, True)
            else:
                setattr(ns, name, str(values).lower() in ("true", "1", "yes"))

    parser.add_argument(f"--{name}", nargs="?", action=_BoolAction,
                        default=default, metavar="BOOL")
    parser.add_argument(f"--no{name}", nargs=0, action=_BoolAction,
                        dest=name, help=argparse.SUPPRESS)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="stochastic_gcn_tpu_torch trainer",
        fromfile_prefix_chars="@")
    for f in dataclasses.fields(Config):
        if isinstance(f.default, bool):
            _add_bool_flag(parser, f.name, f.default)
        else:
            parser.add_argument(f"--{f.name}", type=type(f.default),
                                default=f.default)
    return parser


def parse_flags(argv: Optional[Sequence[str]] = None) -> Config:
    ns = build_parser().parse_args(argv)
    return Config(**{f.name: getattr(ns, f.name)
                     for f in dataclasses.fields(Config)})
