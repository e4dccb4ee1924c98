"""The byte and operation counters against counts made by hand."""

import numpy as np
import pytest
import torch

from gpubench import counts, data, model, peaks, reference


def _graph():
    # 0-1, 0-2, 1-2, 3-4, both ways, rows sorted
    rows = {0: [1, 2], 1: [0, 2], 2: [0, 1], 3: [4], 4: [3]}
    indptr = torch.tensor([0, 2, 4, 6, 7, 8])
    indices = torch.tensor([c for r in range(5) for c in rows[r]])
    return indptr, indices


STEPS = model.layers({"hidden1": 4, "num_fc_layers": 1, "num_layers": 2,
                      "normalization": "graphsage", "layer_norm": True},
                     feature_dim=3, num_classes=2, preprocess=False)


def test_model_steps():
    assert [type(s).__name__ for s in STEPS] == [
        "Aggregate", "Dense", "Aggregate", "Dense"]
    assert [(s.fan_in, s.fan_out, s.rows) for s in STEPS[1::2]] == [
        (6, 4, 1), (8, 2, 2)]


def test_exact_train_step_by_hand():
    indptr, indices = _graph()
    batch = torch.tensor([0, 3, 5])          # 5: padding
    got = counts.exact_step(indptr, indices, batch, STEPS, 3, train=True)
    # field 2 = {0, 3}; field 1 = {0, 3, 1, 2, 4}; field 0 = field 1
    # aggregation 0 (width 3, no gradient): 5 distinct rows, 8 edges,
    # 5 output rows: 4*5*3 + 8*8 + 4*5*3
    # aggregation 1 (width 4): 3 distinct rows, 3 edges, 2 output rows,
    # forward 4*3*4 + 8*3 + 4*2*4, backward 4*2*4 + 8*3 + 4*3*4
    assert got["fanout_bytes"] == 184 + 104 + 104
    # dense0 on 5 rows 6x4: forward and weight gradient (its input has
    # none); dense1 on 2 rows 8x2: forward and both gradients;
    # aggregations 2*8*3, and 2*3*4 forward and backward
    assert got["flops"] == 2 * 240 + 3 * 64 + 48 + 2 * 24


def test_exact_eval_step_by_hand():
    indptr, indices = _graph()
    got = counts.exact_step(indptr, indices, torch.tensor([0, 3]), STEPS, 3,
                            train=False)
    assert got["fanout_bytes"] == 184 + 104
    assert got["flops"] == 240 + 64 + 48 + 24


def test_full_term_by_hand():
    indptr, indices = _graph()
    # rows {0, 3}: 3 distinct neighbours {1, 2, 4}, 3 edges, bf16 rows of 4
    assert counts.full_term_step(indptr, indices, torch.tensor([0, 3, 5]),
                                 4, 2) == 3 * 4 * 2 + 8 * 3 + 4 * 2 * 4


def test_peaks():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.FLOAT32_FLOP_PER_S == 67e12


@pytest.mark.parametrize("cap", [3, 8, 16])
def test_capped_rows_repeat_the_ports_cap(cap):
    """The reference's frozen copy of the cap at ``pad_degree`` draws the
    same edges, in the same order and at the same weights, as the port's
    ``cap_adj_degree`` over the adjacency the benchmark hands it."""
    from stochastic_gcn_tpu_torch.data.preprocess import cap_adj_degree
    g = data.draw({"num_nodes": 400, "avg_degree": 12, "feature_dim": 2,
                   "num_classes": 2, "train_share": 0.66, "val_share": 0.1},
                  7, "cpu")
    seed = 2 ** 40 + 3
    port = cap_adj_degree(data.normalised_adjacency(g.indptr, g.indices,
                                                    400), cap, seed)
    ref = reference.capped(g.indptr, g.indices, cap, seed)
    assert np.array_equal(port.indptr, ref.indptr.numpy())
    assert np.array_equal(port.indices, ref.indices.numpy())
    assert np.array_equal(port.data.astype(np.float32), ref.w.numpy())
    assert int((np.diff(port.indptr) == cap).sum()) > 0
