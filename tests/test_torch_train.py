"""The ported training slice (CV+PP) on the CPU, against the JAX package.

The same numpy inputs go through the JAX function and its port.  Where
sampling is involved, the JAX side produces the pack (``BatchFields``) or
sampling is made deterministic (exhaustive degree) with dropout off, since
the two frameworks draw different random streams.  Tolerances:

* the fanout backward: atol 1e-6 (float32 sums in another order);
* Adam: atol 1e-7 over 3 updates (the same float32 arithmetic);
* one train step: rtol = atol = 1e-5 for the loss, gradients, Adam state
  and params; the scattered bf16 history to one bf16 ulp (both round to
  nearest even, from float32 activations that agree to ~1e-7);
* a two-epoch exhaustive-degree trajectory: atol 1e-4;
* a sampled CV+PP run: val micro-F1 within 0.03 of JAX's, mean of 3 seeds.
"""

import dataclasses
import os
import re
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from stochastic_gcn_tpu.config import Config, parse_flags
from stochastic_gcn_tpu.data import graph as JG
from stochastic_gcn_tpu.data import loaders as JLd
from stochastic_gcn_tpu.models import gcn as JM
from stochastic_gcn_tpu.ops import pallas_spmm as PS
from stochastic_gcn_tpu.sampler import scheduler as JS
from stochastic_gcn_tpu.training import step as JStep
from stochastic_gcn_tpu.training.loop import Trainer as JaxTrainer

from stochastic_gcn_tpu_torch.config import from_fields
from stochastic_gcn_tpu_torch.cli import train as train_cli
from stochastic_gcn_tpu_torch.data import graph as G
from stochastic_gcn_tpu_torch.data import loaders as Ld
from stochastic_gcn_tpu_torch.models import aggregators as A
from stochastic_gcn_tpu_torch.models import gcn as M
from stochastic_gcn_tpu_torch.ops import cuda_spmm as K
from stochastic_gcn_tpu_torch.sampler import scheduler as S
from stochastic_gcn_tpu_torch.training import checkpoint as C
from stochastic_gcn_tpu_torch.training import step as St
from stochastic_gcn_tpu_torch.training.loop import Trainer


def port_cfg(cfg):
    """The port's own ``Config`` with the fields of the JAX package's."""
    return from_fields(dataclasses.asdict(cfg))

DATASET = "synthetic:240:16:5"
# the training recipe of bench.py at small width and batch
FLAGS = ["--dataset", DATASET, "--batch_size", "32", "--degree", "1",
         "--test_degree", "1", "--cv", "--test_cv", "--hidden1", "16",
         "--normalization", "graphsage", "--layer_norm",
         "--num_fc_layers", "2", "--weight_decay", "0", "--dropout", "0.2",
         "--pad_degree", "64", "--seed", "1", "--test_batch_size", "48"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().float().cpu().numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flags(ckpt_dir, *extra):
    return parse_flags(FLAGS + ["--ckpt_dir", str(ckpt_dir), *extra])


def _slots(seed, c, f, k, d):
    """x [c, d], g [f, d], pos/w [f, k] with repeated positions, parked
    positions (>= c) and zero weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c, d)).astype(np.float32)
    g = rng.normal(size=(f, d)).astype(np.float32)
    pos = rng.integers(0, c // 3, (f, k)).astype(np.int32)    # repeats
    pos[rng.random((f, k)) < 0.2] = c + 7                     # parked
    w = rng.uniform(0.1, 1.0, (f, k)).astype(np.float32)
    w[rng.random((f, k)) < 0.2] = 0.0
    return x, g, pos, w


# ------------------------------ the kernel --------------------------------

@pytest.mark.parametrize("shape", [(24, 10, 1, 8), (40, 13, 8, 16),
                                   (1024, 512, 1, 32)])
def test_fanout_backward_plain_matches_jax_vjp(shape):
    c, f, k, d = shape
    x, g, pos, w = _slots(20, c, f, k, d)
    _, vjp = jax.vjp(lambda x_: PS.fanout_aggregate_xla(
        x_, jnp.asarray(pos), jnp.asarray(w)), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = K.fanout_aggregate_backward_ref(T(g), T(pos), T(w), c)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=0, atol=1e-6)
    # the wrapper on CPU tensors, and autograd through the plain forward
    np.testing.assert_allclose(
        N(K.fanout_aggregate_backward(T(g), T(pos), T(w), c)),
        np.asarray(want), rtol=0, atol=1e-6)
    xt = T(x).requires_grad_()
    K.fanout_aggregate_ref(xt, T(pos), T(w)).backward(T(g))
    np.testing.assert_allclose(N(xt.grad), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_fanout_aggregate_gradcheck():
    """float64 end to end: the plain versions keep a float64 input's
    dtype, so gradcheck's finite differences are meaningful."""
    x, _, pos, w = _slots(21, 12, 7, 5, 4)
    xt = torch.from_numpy(x).double().requires_grad_()
    assert torch.autograd.gradcheck(K.FanoutAggregate.apply,
                                    (xt, T(pos), T(w)))


def test_fanout_aggregate_carries_the_gradient():
    """Repair: the fanout goes through FanoutAggregate, whose backward is
    the kernel's transpose; weights that require grad raise."""
    x, g, pos, w = _slots(22, 30, 9, 4, 8)
    xt = T(x).requires_grad_()
    out = A.fanout_gather(xt, T(pos), T(w))
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__.startswith("FanoutAggregate")
    out.backward(T(g))
    np.testing.assert_allclose(
        N(xt.grad), N(K.fanout_aggregate_backward_ref(T(g), T(pos), T(w),
                                                      30)),
        rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="require grad"):
        K.fanout_aggregate(T(x), T(pos), T(w).requires_grad_())


def _cv_slots(seed, n, c, f, k, d):
    """``_slots`` plus a history with garbage in the sentinel row ``n``, a
    field with sentinel ids, and the full term's output ``base``."""
    x, g, pos, w = _slots(seed, c, f, k, d)
    rng = np.random.default_rng(seed + 1000)
    hist = rng.normal(size=(n + 8, d)).astype(np.float32)
    hist[n] = 1e3
    field_in = rng.integers(0, n, c).astype(np.int32)
    field_in[rng.random(c) < 0.2] = n
    base = rng.normal(size=(f, d)).astype(np.float32)
    return x, g, pos, w, hist, field_in, base


@pytest.mark.parametrize("shape", [(24, 10, 1, 8), (40, 13, 5, 16)])
def test_cv_fanout_gradient_matches_jax_vjp(shape):
    """The gradient of the whole CV delta with respect to x is the fanout
    term's: the history and the full term are constants."""
    from stochastic_gcn_tpu.models import aggregators as JA
    c, f, k, d = shape
    n = 20
    x, g, pos, w, hist, field_in, base = _cv_slots(40, n, c, f, k, d)

    def expr(x_):
        delta = x_ - JA.history_gather(jnp.asarray(hist),
                                       jnp.asarray(field_in), None, n)
        return JA.fanout_gather(delta, jnp.asarray(pos), jnp.asarray(w)) \
            + jnp.asarray(base)

    want_out, vjp = jax.vjp(expr, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = T(x).requires_grad_()
    out = K.cv_fanout_aggregate(xt, T(hist), T(field_in), n, T(pos), T(w),
                                T(base))
    np.testing.assert_allclose(N(out), np.asarray(want_out), **TOL)
    out.backward(T(g))
    np.testing.assert_allclose(N(xt.grad), np.asarray(want), rtol=0,
                               atol=1e-6)
    # autograd through the plain version gives the same gradient
    xr = T(x).requires_grad_()
    K.cv_fanout_aggregate_ref(xr, T(hist), T(field_in), n, T(pos), T(w),
                              T(base)).backward(T(g))
    np.testing.assert_allclose(N(xr.grad), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_cv_fanout_aggregate_gradcheck():
    n = 9
    x, _, pos, w, hist, field_in, base = _cv_slots(41, n, 12, 7, 5, 4)
    xt = torch.from_numpy(x).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x_: K.CVFanoutAggregate.apply(
            x_, T(hist).double(), T(field_in), n, T(pos), T(w),
            T(base).double()), (xt,))


def test_cv_fanout_survives_the_in_place_history_scatter():
    """The train step scatters new rows into the history in place between
    the forward and the backward of the next use; the function saves only
    the slots, so autograd's version check has nothing to trip on."""
    n = 20
    x, g, pos, w, hist, field_in, base = _cv_slots(42, n, 30, 9, 4, 8)
    xt, ht = T(x).requires_grad_(), T(hist)
    out = A.vr_aggregate(
        xt, S.LayerSample(slot_pos=T(pos), slot_w=T(w), slot_aw=None,
                          scales=torch.ones(9)),
        T(field_in), T(field_in[:9]), _tiny_graph(n), (ht,), False, "gcn")[0]
    assert type(out.grad_fn).__name__.startswith("CVFanoutAggregate")
    ht.index_copy_(0, torch.arange(5), torch.ones(5, 8))     # in place
    out.backward(T(g))
    np.testing.assert_allclose(
        N(xt.grad), N(K.fanout_aggregate_backward_ref(T(g), T(pos), T(w),
                                                      30)),
        rtol=0, atol=1e-6)


def _tiny_graph(n):
    rng = np.random.default_rng(43)
    rows = np.repeat(np.arange(n), 3)
    adj = G.sp.csr_matrix((np.ones(rows.size, np.float32),
                           (rows, rng.integers(0, n, rows.size))),
                          shape=(n, n))
    adj.sum_duplicates()
    return G.pad_csr(adj)


def test_full_term_refuses_a_table_that_requires_grad():
    """Repair: the full term has no backward, so a table or weights that
    require grad raise instead of losing the gradient silently."""
    x, _, pos, w = _slots(23, 30, 9, 4, 8)
    with pytest.raises(ValueError, match="no backward"):
        K.hbm_gather_aggregate(T(x).requires_grad_(), T(pos), T(w))
    with pytest.raises(ValueError, match="no backward"):
        K.hbm_gather_aggregate(T(x), T(pos), T(w).requires_grad_())
    with pytest.raises(ValueError, match="history"):
        A.history_gather(T(x).requires_grad_(), T(pos[:, 0]), 30)


@pytest.mark.parametrize("g_rows, g_dims, rows", [(8, 2, 30), (10, 2, 30),
                                                  (1, 2, 30), (9, 1, 30),
                                                  (9, 2, -1)])
def test_fanout_backward_refuses_mismatched_shapes(g_rows, g_dims, rows):
    """The backward wrapper takes one gradient row per row of ``pos`` and a
    non-negative row count, and raises on anything else (a one-row ``g``
    must not broadcast)."""
    _, g, pos, w = _slots(27, 30, 9, 4, 8)
    g = np.resize(g, (g_rows, 8))
    gt = T(g) if g_dims == 2 else T(g[:, 0].copy())
    with pytest.raises(ValueError, match="one row per row|rows must be"):
        K.fanout_aggregate_backward(gt, T(pos), T(w), rows)


def test_fanout_gather_refuses_to_copy_slots():
    """Repair: slots that are not contiguous int32 / float32 raise instead
    of being cast and copied on every call."""
    x, _, pos, w = _slots(24, 30, 9, 4, 8)
    with pytest.raises(TypeError, match="int32"):
        A.fanout_gather(T(x), T(pos).long(), T(w))
    with pytest.raises(ValueError, match="contiguous"):
        A.fanout_gather(T(x), T(pos).t().contiguous().t(), T(w))


# ------------------------------- Adam -------------------------------------

def test_adam_matches_optax():
    rng = np.random.default_rng(25)
    shapes = {"dense0": {"weights": (6, 4), "offset": (1, 4)},
              "dense1": {"weights": (4, 3)}}
    params = {l: {n: rng.normal(size=s).astype(np.float32)
                  for n, s in p.items()} for l, p in shapes.items()}
    cfg = Config(learning_rate=0.01, beta1=0.9, beta2=0.999)
    tx = optax.adam(0.01, b1=0.9, b2=0.999, eps=1e-8)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    adam = St.make_optimizer(port_cfg(cfg))
    tp = C.params_from_jax(params)
    tstate = adam.init(tp)
    for i in range(3):
        grads = {l: {n: rng.normal(size=s).astype(np.float32) * 10 ** -i
                     for n, s in p.items()} for l, p in shapes.items()}
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        adam.update(C.params_from_jax(grads), tstate, tp)
    for l, n in St.param_keys(tp):
        np.testing.assert_allclose(N(tp[l][n]), np.asarray(jp[l][n]),
                                   rtol=0, atol=1e-7)
    got = C.opt_state_to_jax(tstate)
    assert got["count"] == np.asarray(jstate[0].count) == 3
    for m in ("mu", "nu"):
        for l, n in St.param_keys(tp):
            np.testing.assert_allclose(got[m][l][n],
                                       np.asarray(getattr(jstate[0],
                                                          m)[l][n]),
                                       rtol=0, atol=1e-7)
    # and back: a JAX state carried into the port equals the port's own
    back = C.opt_state_from_jax(_np_tree(jstate))
    torch.testing.assert_close(back.mu, tstate.mu, rtol=0, atol=1e-7)


# ------------------------------ one step ----------------------------------

@pytest.fixture(scope="module")
def graphs():
    ds = JLd.synthetic_dataset(num_nodes=240, feature_dim=16, num_classes=5,
                               normalization="graphsage", seed=0)
    return ds, JG.pad_csr(ds.train_adj), G.pad_csr(ds.train_adj)


def _bf16_values(rng, shape, n):
    """Random history values that are exactly bfloat16, row N garbage."""
    h = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    h[n] = 1e3
    return h.to(torch.bfloat16)


def test_train_step_matches_jax(graphs):
    ds, jg, tg = graphs
    n = ds.num_data
    cfg = Config(batch_size=32, degree=1, cv=True, test_cv=True, hidden1=16,
                 normalization="graphsage", layer_norm=True,
                 num_fc_layers=2, weight_decay=5e-4, dropout=0.0,
                 pad_degree=64, seed=1)
    jspec = JM.build_model_spec(cfg, ds.feature_dim, ds.num_classes, True,
                                True, False)
    spec = M.build_model_spec(port_cfg(cfg), ds.feature_dim, ds.num_classes, True,
                              True, False)
    feats = np.hstack((ds.feats, ds.train_feats)).astype(np.float32)
    rng = np.random.default_rng(26)
    hist = _bf16_values(rng, (248, cfg.hidden1), n)
    batch = np.r_[rng.choice(ds.train_d, 28, replace=False),
                  [n] * 4].astype(np.int32)
    jpack = JS.schedule(jax.random.PRNGKey(3), jg, jnp.asarray(batch), (1,),
                        cv=True, dedup=False)

    jparams = JM.init_params(jax.random.PRNGKey(4), jspec)
    jstate = JStep.TrainState(
        params=jparams, opt_state=JStep.make_optimizer(cfg).init(jparams),
        histories=((jnp.asarray(N(hist)).astype(jnp.bfloat16),),),
        step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(JStep.build_train_step(cfg, jspec, (1,), n))
    jstate, jm = jstep(jstate, jg, JG.dense_rows(feats, n),
                       JG.dense_rows(ds.labels, n), jnp.zeros((n + 1,)),
                       jnp.asarray(batch), jax.random.PRNGKey(0),
                       pack=jpack)

    params = C.params_from_jax(_np_tree(jparams))
    state = St.TrainState(params=params,
                          opt_state=St.make_optimizer(port_cfg(cfg)).init(params),
                          histories=((hist.clone(),),),
                          step=torch.zeros((), dtype=torch.int32))
    pack = S.BatchFields(
        fields=tuple(T(f) for f in jpack.fields),
        layers=tuple(S.LayerSample(slot_pos=T(ls.slot_pos),
                                   slot_w=T(ls.slot_w), slot_aw=None,
                                   scales=T(ls.scales))
                     for ls in jpack.layers))
    step = St.build_train_step(port_cfg(cfg), spec, (1,), n)
    state, m = step(state, tg, G.dense_rows(feats, n),
                    G.dense_rows(ds.labels, n), T(batch),
                    torch.Generator(), pack=pack)

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]),
                               **TOL)
    jopt = jstate.opt_state[0]
    assert int(state.opt_state.count) == int(jopt.count) == 1
    assert int(state.step) == int(jstate.step) == 1
    for l, k in St.param_keys(params):
        # after one update mu = (1 - b1) * grad exactly: the gradients
        np.testing.assert_allclose(
            N(state.opt_state.mu[l][k]) / (1 - cfg.beta1),
            np.asarray(jopt.mu[l][k]) / (1 - cfg.beta1), **TOL)
        np.testing.assert_allclose(N(state.opt_state.nu[l][k]),
                                   np.asarray(jopt.nu[l][k]), **TOL)
        np.testing.assert_allclose(N(state.params[l][k]),
                                   np.asarray(jstate.params[l][k]), **TOL)
    got_h = N(state.histories[0][0])
    want_h = np.asarray(jstate.histories[0][0].astype(jnp.float32))
    ulp = np.spacing(np.abs(want_h)) * 2 ** 16     # bf16 ulp
    assert state.histories[0][0].dtype == torch.bfloat16
    assert (np.abs(got_h - want_h) <= ulp).all()
    assert (got_h != N(hist)).any()               # the scatter happened
    assert int(m["amt_data"]) == int(jm["amt_data"])
    for k in ("field_sizes", "adj_sizes", "fadj_sizes"):
        np.testing.assert_array_equal(N(m[k]).astype(np.int64),
                                      np.asarray(jm[k]))


# ---------------------------- trajectories --------------------------------

def _exhaustive_cfg(ckpt_dir, **over):
    """Exhaustive degree (every neighbour, so sampling is deterministic),
    dropout off, batch x max degree <= 2N (no forced dedup)."""
    return _flags(ckpt_dir, "--degree", "10000", "--test_degree", "10000",
                  "--dropout", "0", "--pad_degree", "-1", "--batch_size",
                  "16", "--test_batch_size", "24").replace(**over)


def test_two_epoch_trajectory_matches_jax(tmp_path):
    cfg = _exhaustive_cfg(tmp_path)
    ds = JLd.load_data(cfg)
    jt = JaxTrainer(cfg, ds)
    tt = Trainer(port_cfg(cfg), ds, device="cpu")
    init = _np_tree(jt.state.params)
    for l, k in St.param_keys(tt.params):
        tt.params[l][k].copy_(T(init[l][k]))
    tt.state.opt_state = C.opt_state_from_jax(_np_tree(jt.state.opt_state))
    for _ in range(2):
        jloss, jacc, _, _ = jt.train_epoch()
        loss, acc, _, _ = tt.train_epoch()
        np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-4)
        np.testing.assert_allclose(acc, jacc, rtol=0, atol=1e-6)
    assert tt.amt_data == jt.amt_data
    final = _np_tree(jt.state.params)
    for l, k in St.param_keys(tt.params):
        np.testing.assert_allclose(N(tt.params[l][k]), final[l][k], rtol=0,
                                   atol=1e-4)
    want = jt.evaluate(ds.val_d)
    got = tt.evaluate(ds.val_d)
    np.testing.assert_allclose(got[:4], want[:4], rtol=0, atol=1e-4)


def test_community_sbm_dataset_matches_jax():
    kw = dict(num_nodes=700, num_classes=6, feature_dim=10, mean_degree=8,
              p_in=0.7, snr=0.3, max_degree=12, seed=3)
    want, got = JLd.community_sbm_dataset(**kw), Ld.community_sbm_dataset(**kw)
    for name in ("train_adj", "full_adj"):
        a, b = getattr(want, name), getattr(got, name)
        assert (a != b).nnz == 0
        np.testing.assert_array_equal(a.indptr, b.indptr)
    for name in ("feats", "train_feats", "test_feats", "labels", "train_d",
                 "val_d", "test_d"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))


def test_minibatch_order_matches_jax():
    ids = np.random.default_rng(27).permutation(500)[:300].astype(np.int32)
    want = JS.MinibatchIterator(ids, 32, 500, seed=5)
    got = S.MinibatchIterator(ids, seed=5)
    for _ in range(3):
        want.shuffle()
        got.shuffle()
        np.testing.assert_array_equal(got.data, want.data)


def test_sampled_cvpp_accuracy_matches_jax(tmp_path):
    """degree 1, dropout 0.2: the sampling streams differ, so the runs are
    held by their outcome, val micro-F1 averaged over 3 seeds."""
    ds = Ld.community_sbm_dataset(num_nodes=1024, num_classes=4,
                                  feature_dim=16, mean_degree=12, p_in=0.8,
                                  snr=0.35, max_degree=16, val_frac=0.3,
                                  seed=0)
    f1 = {"jax": [], "port": []}
    for seed in (1, 2, 3):
        cfg = Config(dataset="sbm", batch_size=64, degree=1, test_degree=1,
                     cv=True, test_cv=True, hidden1=16,
                     normalization="graphsage", layer_norm=True,
                     num_fc_layers=2, weight_decay=0.0, dropout=0.2,
                     test_batch_size=256, pad_degree=16, seed=seed,
                     ckpt_dir=str(tmp_path))
        for name, tr in (("jax", JaxTrainer(cfg, ds)),
                         ("port", Trainer(port_cfg(cfg), ds, device="cpu"))):
            for _ in range(8):
                tr.train_epoch()
            tr.predict(ds.val_d)                 # converge CV inference
            f1[name].append(tr.evaluate(ds.val_d)[2])
    mean = {k: float(np.mean(v)) for k, v in f1.items()}
    assert mean["jax"] > 0.6, f1           # the task was learnt
    assert abs(mean["port"] - mean["jax"]) <= 0.03, f1


# ----------------------------- checkpoints --------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX Trainer after one epoch of sgd_train: its checkpoint directory
    and its log lines."""
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    cfg = _flags(ckpt)
    ds = JLd.load_data(cfg)
    jt = JaxTrainer(cfg, ds)
    lines = []
    jt.sgd_train(log=lines.append, max_epochs=1)
    return jt, ds, str(ckpt), lines


def test_jax_checkpoint_resumes_in_port(jax_run, tmp_path):
    jt, ds, ckpt, _ = jax_run
    tt = Trainer(_flags(ckpt, "--resume"), ds, device="cpu")
    logs = []
    assert tt._try_resume(logs.append) == 1
    assert logs == [f"resume: continuing from epoch 2 (data = "
                    f"{jt.amt_data})"]
    assert (tt.completed_epochs, tt.amt_data) == (1, jt.amt_data)
    np.testing.assert_allclose(tt.cost_val, jt.cost_val, rtol=0, atol=0)
    want = _np_tree(jt.state)
    for l, k in St.param_keys(tt.params):
        np.testing.assert_array_equal(N(tt.params[l][k]),
                                      want.params[l][k])
        np.testing.assert_array_equal(N(tt.state.opt_state.mu[l][k]),
                                      want.opt_state[0].mu[l][k])
        np.testing.assert_array_equal(N(tt.state.opt_state.nu[l][k]),
                                      want.opt_state[0].nu[l][k])
    assert int(tt.state.opt_state.count) == int(want.opt_state[0].count)
    assert int(tt.state.step) == int(want.step)
    assert tt.state.histories[0][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        N(tt.state.histories[0][0]),
        np.asarray(jt.state.histories[0][0].astype(jnp.float32)))
    # the eval histories are the train ones, cast to float32, as in JAX
    np.testing.assert_array_equal(N(tt.eval_histories[0][0]),
                                  N(tt.state.histories[0][0]))


def test_port_checkpoint_loads_in_jax(jax_run, tmp_path):
    cfg = _flags(tmp_path)
    ds = Ld.load_data(port_cfg(cfg))
    tt = Trainer(port_cfg(cfg), ds, device="cpu")
    tt.train_epoch()
    tt.save()
    with np.load(C.checkpoint_path(str(tmp_path))) as z, \
            np.load(C.checkpoint_path(jax_run[2])) as jz:
        # the same entries, under the same names, as a JAX run's file
        assert sorted(z.files) == sorted(jz.files)
        np.testing.assert_array_equal(z["leaf:['key']"],
                                      np.asarray(jax.random.PRNGKey(1)))
    jt = JaxTrainer(cfg, ds)
    jt.load()                      # requires every leaf of its template
    want = jt.predict(np.asarray(ds.test_d))
    got = tt.predict(np.asarray(ds.test_d))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert int(jt.state.opt_state[0].count) == \
        int(tt.state.opt_state.count) == int(jt.state.step)


def test_port_save_resume_round_trip(tmp_path):
    cfg = _flags(tmp_path, "--epochs", "1", "--early_stopping", "100")
    ds = Ld.load_data(port_cfg(cfg))
    first = Trainer(port_cfg(cfg), ds, device="cpu")
    first.sgd_train(log=lambda s: None, max_epochs=2)
    again = Trainer(port_cfg(cfg.replace(resume=True)), ds, device="cpu")
    logs = []
    again.sgd_train(log=logs.append, max_epochs=2)   # nothing left to run
    assert logs[0] == f"resume: continuing from epoch 3 (data = " \
        f"{first.amt_data})"
    assert again.completed_epochs == first.completed_epochs == 2
    assert again.amt_data == first.amt_data
    assert again.cost_val == first.cost_val
    for l, k in St.param_keys(first.params):
        torch.testing.assert_close(again.params[l][k], first.params[l][k],
                                   rtol=0, atol=0)
    torch.testing.assert_close(again.state.histories,
                               first.state.histories, rtol=0, atol=0)


def test_load_copies_the_train_histories_into_eval(tmp_path):
    """Repair: as in JAX, load() leaves the eval histories equal to the
    CURRENT train histories cast to the eval dtype (it used to zero
    them)."""
    cfg = _flags(tmp_path)
    ds = Ld.load_data(port_cfg(cfg))
    tr = Trainer(port_cfg(cfg), ds, device="cpu")
    tr.save()
    h = tr.state.histories[0][0]
    h.copy_(torch.randn(h.shape, generator=torch.Generator().manual_seed(0)))
    tr.load()                      # weights only; train histories stay
    assert tr.eval_histories[0][0].dtype == torch.float32
    torch.testing.assert_close(tr.eval_histories[0][0], h.float(), rtol=0,
                               atol=0)
    assert tr.eval_histories[0][0].abs().sum() > 0


def test_non_finite_edge_weights_raise(tmp_path):
    """Repair: the reference's runtime data guard (JAX Trainer, loop.py
    :172-177)."""
    ds = Ld.load_data(_flags(tmp_path))
    bad = ds.train_adj.copy()
    bad.data[3] = np.nan
    ds.train_adj = bad
    with pytest.raises(ValueError, match="non-finite edge weights"):
        Trainer(_flags(tmp_path), ds, device="cpu")


# ------------------------------ sgd_train ---------------------------------

def _mask_numbers(line):
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)


def test_sgd_train_log_lines_match_jax(jax_run, tmp_path):
    _, ds, _, jlines = jax_run
    tt = Trainer(_flags(tmp_path), ds, device="cpu")
    lines = []
    tt.sgd_train(log=lines.append, max_epochs=1)
    assert [_mask_numbers(s) for s in lines] == \
        [_mask_numbers(s) for s in jlines]
    assert lines[0].startswith("Epoch: 0001 train_loss= ")
    assert lines[1].startswith("TF time = ")
    assert lines[-1] == "Optimization Finished!"


def _scripted_costs(tr, costs):
    """evaluate() returns the given validation costs in turn."""
    it = iter(costs)
    tr.evaluate = lambda ids: (next(it), 0.5, 0.5, 0.5, 0.0)


def test_sgd_train_early_stopping(tmp_path):
    cfg = _flags(tmp_path, "--early_stopping", "2", "--epochs", "100")
    tr = Trainer(port_cfg(cfg), Ld.load_data(port_cfg(cfg)), device="cpu")
    _scripted_costs(tr, [1.0, 0.9, 0.8, 0.86, 0.9, 0.7])
    lines = []
    tr.sgd_train(log=lines.append, max_epochs=10)
    # 0-based epoch 3 > 2 and 0.86 > mean(0.9, 0.8)
    assert tr.completed_epochs == 4
    assert "Early stopping..." in lines


@pytest.mark.parametrize("data, epochs_run", [(0, 3), (10 ** 12, 5)])
def test_sgd_train_data_budget(tmp_path, data, epochs_run):
    """Stop once the edge budget is spent and the 0-based epoch exceeds
    --epochs (train.py:234); a budget not spent keeps training."""
    cfg = _flags(tmp_path, "--epochs", "1", "--data", str(data),
                 "--early_stopping", "100")
    tr = Trainer(port_cfg(cfg), Ld.load_data(port_cfg(cfg)), device="cpu")
    tr.sgd_train(log=lambda s: None, max_epochs=5)
    assert tr.completed_epochs == epochs_run


def test_sigterm_keeps_the_handler_until_the_final_save(tmp_path):
    cfg = _flags(tmp_path, "--epochs", "50", "--early_stopping", "100")
    tr = Trainer(port_cfg(cfg), Ld.load_data(port_cfg(cfg)), device="cpu")
    seen = []
    original = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda *a: seen.append("previous"))
    try:
        outer = signal.getsignal(signal.SIGTERM)
        tr.install_preemption_handler()
        ours = signal.getsignal(signal.SIGTERM)
        assert ours is not outer
        train_epoch, save = tr.train_epoch, tr.save

        def epoch_then_sigterm():
            out = train_epoch()
            if tr.completed_epochs == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        def save_checking_handler():
            seen.append(("save", signal.getsignal(signal.SIGTERM) is ours))
            path = save()
            seen.append(("saved", os.path.exists(path),
                         signal.getsignal(signal.SIGTERM) is ours))
            return path

        tr.train_epoch, tr.save = epoch_then_sigterm, save_checking_handler
        lines = []
        tr.sgd_train(log=lines.append)
        assert tr.stop_requested and tr.completed_epochs == 2
        assert any(s.startswith("Preemption stop after epoch 2")
                   for s in lines)
        assert seen == ["previous", ("save", True), ("saved", True, True)]
        assert signal.getsignal(signal.SIGTERM) is outer     # restored
    finally:
        signal.signal(signal.SIGTERM, original)


def test_profile_dir_traces_the_listed_epochs(tmp_path):
    prof = tmp_path / "prof"
    cfg = _flags(tmp_path, "--profile_dir", str(prof), "--profile_epochs",
                 "2", "--epochs", "0")
    tr = Trainer(port_cfg(cfg), Ld.load_data(port_cfg(cfg)), device="cpu")
    lines = []
    tr.sgd_train(log=lines.append, max_epochs=2)
    assert sorted(os.listdir(prof)) == ["epoch2.trace.json"]
    assert f"profiler trace of epoch 2 written to " \
        f"{prof / 'epoch2.trace.json'}" in lines


# -------------------------------- the CLI ---------------------------------

def test_cli_train_end_to_end(tmp_path, capsys):
    ckpt = str(tmp_path)
    tr = train_cli.main(FLAGS + ["--ckpt_dir", ckpt, "--epochs", "1",
                                 "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Features shape = (240, 16)")
    epochs = [s for s in out if s.startswith("Epoch: ")]
    assert [s[:11] for s in epochs] == ["Epoch: 0001", "Epoch: 0002",
                                        "Epoch: 0003"]
    assert "Optimization Finished!" in out
    assert f"Model saved in file: {C.checkpoint_path(ckpt)}" in out
    tests = [s for s in out if s.startswith("Test set results: cost= ")]
    assert len(tests) == tr.cfg.num_layers + 1
    assert os.path.exists(C.checkpoint_path(ckpt))


@pytest.mark.parametrize("over", [
    {"importance": True, "is_row_table": True}, {"partition_nodes": "bfs"},
    {"tp": 2}, {"ckpt_async": True},
    {"test_importance": True, "is_row_table": True}, {"dp": 2}])
def test_unported_training_options_raise(tmp_path, over):
    cfg = _flags(tmp_path)
    ds = Ld.load_data(port_cfg(cfg))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(port_cfg(cfg.replace(**over)), ds, device="cpu")


def test_cli_train_refuses_mlp(tmp_path, capsys):
    """``--model mlp`` is ported: the CLI trains the NeighbourMLP and prints
    the epoch and Test lines instead of refusing."""
    from stochastic_gcn_tpu_torch.models.mlp import MLPTrainer
    tr = train_cli.main(FLAGS + ["--ckpt_dir", str(tmp_path), "--model",
                                 "mlp", "--epochs", "2", "--device", "cpu"])
    assert isinstance(tr, MLPTrainer)
    out = capsys.readouterr().out.splitlines()
    assert [s[:11] for s in out if s.startswith("Epoch: ")] == \
        ["Epoch: 0001", "Epoch: 0002"]
    assert out[-1].startswith("Test set results: cost= ")
