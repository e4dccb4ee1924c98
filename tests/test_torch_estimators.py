"""The estimator family of the port on the CPU, against the JAX package:
dedup-compacted fields, the CVD and det-dropout layers and aggregator
branches, the train step of each estimator, pred-and-grad, the gradient
variance harness, Polyak averaging and its checkpoints.

The same numpy inputs go through the JAX function and its port.  Where
sampling or dropout is involved, the JAX side draws the neighbours
(``expand_uniform`` is replaced by the JAX scheduler's draw) and both sides
take the same numpy dropout masks and Gaussian noise (``shared_noise``),
since the two frameworks draw different random streams; what cannot be
shared is held by statistics.  Tolerances:

* fields, positions and weights of a schedule: exact;
* layers, aggregator branches and their gradients: rtol = atol = 1e-5
  (float32 sums in another order);
* one train step, pred-and-grad: rtol = atol = 1e-4 (a whole forward and
  backward; the det-dropout moments divide by small variances);
* the Polyak average after three steps: atol 1e-5;
* a sampled CVD+PP run: val micro-F1 within 0.05 of JAX's, mean of 2 seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.config import Config, parse_flags
from stochastic_gcn_tpu.data import graph as JG
from stochastic_gcn_tpu.data import loaders as JLd
from stochastic_gcn_tpu.models import aggregators as JA
from stochastic_gcn_tpu.models import gcn as JM
from stochastic_gcn_tpu.ops import layers as JL
from stochastic_gcn_tpu.sampler import scheduler as JS
from stochastic_gcn_tpu.training import step as JStep
from stochastic_gcn_tpu.training.loop import Trainer as JaxTrainer
from stochastic_gcn_tpu.utils import metrics as JMet

from stochastic_gcn_tpu_torch.cli import train as train_cli
from stochastic_gcn_tpu_torch.config import from_fields
from stochastic_gcn_tpu_torch.data import graph as G
from stochastic_gcn_tpu_torch.data import loaders as Ld
from stochastic_gcn_tpu_torch.models import aggregators as A
from stochastic_gcn_tpu_torch.models import gcn as M
from stochastic_gcn_tpu_torch.ops import layers as L
from stochastic_gcn_tpu_torch.sampler import scheduler as S
from stochastic_gcn_tpu_torch.training import checkpoint as C
from stochastic_gcn_tpu_torch.training import step as St
from stochastic_gcn_tpu_torch.training.loop import Trainer
from stochastic_gcn_tpu_torch.utils import metrics as Met

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
WIDTH = 30                    # a feature width that is not a multiple of 4
DATASET = f"synthetic:240:{WIDTH}:5"
FLAGS = ["--dataset", DATASET, "--batch_size", "32", "--degree", "2",
         "--test_degree", "2", "--cv", "--test_cv", "--hidden1", "16",
         "--normalization", "graphsage", "--layer_norm",
         "--num_fc_layers", "2", "--weight_decay", "0", "--dropout", "0.2",
         "--pad_degree", "64", "--seed", "1", "--test_batch_size", "48"]


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def port_cfg(cfg):
    """The port's own ``Config`` with the fields of the JAX package's."""
    return from_fields(dataclasses.asdict(cfg))


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().float().cpu().numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flags(ckpt_dir, *extra):
    return parse_flags(FLAGS + ["--ckpt_dir", str(ckpt_dir), *extra])


@pytest.fixture(scope="module")
def graphs():
    ds = JLd.synthetic_dataset(num_nodes=240, feature_dim=WIDTH,
                               num_classes=5, normalization="graphsage",
                               seed=0)
    return ds, JG.pad_csr(ds.train_adj), G.pad_csr(ds.train_adj)


def _to_torch_pack(jpack):
    return S.BatchFields(
        fields=tuple(T(f) for f in jpack.fields),
        layers=tuple(S.LayerSample(
            slot_pos=T(ls.slot_pos), slot_w=T(ls.slot_w),
            slot_aw=None if ls.slot_aw is None else T(ls.slot_aw),
            scales=T(ls.scales)) for ls in jpack.layers))


def _batch(rng, ds, real, pad):
    n = ds.num_data
    return np.r_[rng.choice(ds.train_d, real, replace=False),
                 [n] * pad].astype(np.int32)


def _noise_rng(shape, salt):
    return np.random.default_rng([salt, len(shape), *shape])


@pytest.fixture
def shared_noise(monkeypatch):
    """Both packages take their dropout masks and Gaussian noise from numpy,
    seeded by the shape alone, in place of their own random streams."""
    def mask(shape, keep_prob):
        return _noise_rng(shape, 1).random(shape) < keep_prob

    def noise(shape):
        return _noise_rng(shape, 2).standard_normal(shape).astype(np.float32)

    def jdropout(key, x, keep_prob):
        if keep_prob >= 1.0:
            return x
        return jnp.where(jnp.asarray(mask(x.shape, keep_prob)), x, 0.0) \
            * (1.0 / keep_prob)

    def tdropout(gen, x, keep_prob):
        if keep_prob >= 1.0:
            return x
        return torch.where(T(mask(tuple(x.shape), keep_prob)), x, 0.0) \
            * (1.0 / keep_prob)

    monkeypatch.setattr(JL, "dropout", jdropout)
    monkeypatch.setattr(L, "dropout", tdropout)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(
                            noise(tuple(shape))))
    monkeypatch.setattr(torch, "randn",
                        lambda shape, generator=None, device=None,
                        dtype=None: T(noise(tuple(shape))))


# ------------------------------ the fields --------------------------------

def test_compact_field_matches_jax(graphs):
    ds, jg, tg = graphs
    n = ds.num_data
    rng = np.random.default_rng(40)
    field = _batch(rng, ds, 20, 4)
    nbr = np.asarray(JS.expand_uniform(jax.random.PRNGKey(1), jg,
                                       jnp.asarray(field), 3, False)[0])
    cap = S.field_capacities(24, (3,), n, tg.pad_degree)[0]
    assert cap == JS.field_capacities(24, (3,), n, jg.pad_degree)[0] \
        == 24 + min(24 * 3, n)
    want_f, want_pos = JS.compact_field(jnp.asarray(field), jnp.asarray(nbr),
                                        n, cap)
    got_f, got_pos = S.compact_field(T(field), T(nbr), n, cap)
    assert got_f.dtype == got_pos.dtype == torch.int32
    assert tuple(got_f.shape) == (cap,) and tuple(got_pos.shape) == (n + 1,)
    np.testing.assert_array_equal(N(got_f), np.asarray(want_f))
    got_f = got_f.numpy()
    np.testing.assert_array_equal(got_f[:24], field)      # prefix invariant
    new = got_f[24:]
    real = new[new < n]
    assert (np.diff(real) > 0).all() and (new[len(real):] == n).all()
    assert set(real) == set(nbr.ravel()) - set(field) - {n}
    # the position table on the ids of the field (the rest is unspecified)
    ids = got_f[got_f < n]
    np.testing.assert_array_equal(got_pos.numpy()[ids],
                                  np.asarray(want_pos)[ids])
    np.testing.assert_array_equal(got_pos.numpy()[ids],
                                  np.nonzero(got_f < n)[0])


def _draw_like_jax(monkeypatch, jg, key):
    """Make the port's scheduler draw the neighbours the JAX scheduler
    draws from ``key`` (one split per layer, as ``JS.schedule`` does)."""
    state = {"key": key}

    def expand(gen, graph, field_out, degree, need_aw):
        state["key"], sub = jax.random.split(state["key"])
        out = JS.expand_uniform(sub, jg, jnp.asarray(field_out.numpy()),
                                degree, need_aw)
        return tuple(None if o is None else T(o) for o in out)

    monkeypatch.setattr(S, "expand_uniform", expand)


@pytest.mark.parametrize("degrees, dedup, compacted", [
    ((2, 3), True, True),             # asked for
    ((1, 1), False, False),           # the append-only layout
    ((10000, 10000), False, True),    # forced: a layer samples > 2N slots
    ((10000,), True, True),           # exhaustive, one layer
])
def test_schedule_matches_jax_on_jax_drawn_neighbours(graphs, monkeypatch,
                                                      degrees, dedup,
                                                      compacted):
    ds, jg, tg = graphs
    n = ds.num_data
    batch = _batch(np.random.default_rng(41), ds, 28, 4)
    key = jax.random.PRNGKey(7)
    want = JS.schedule(key, jg, jnp.asarray(batch), degrees, cv=True,
                       need_aw=True, dedup=dedup)
    _draw_like_jax(monkeypatch, jg, key)
    got = S.schedule(torch.Generator(), tg, T(batch), degrees, cv=True,
                     need_aw=True, dedup=dedup)
    assert S.effective_dedup(dedup, 32, degrees, n, tg.pad_degree) \
        is compacted
    caps = S.field_capacities(32, degrees, n, tg.pad_degree, dedup=compacted)
    assert [f.shape[0] for f in got.fields] == caps
    for f, jf in zip(got.fields, want.fields):
        assert f.dtype == torch.int32 and f.is_contiguous()
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    for l, (ls, jls) in enumerate(zip(got.layers, want.layers)):
        assert ls.slot_pos.dtype == torch.int32 and \
            ls.slot_pos.is_contiguous() and ls.slot_w.is_contiguous()
        np.testing.assert_array_equal(ls.slot_w.numpy(),
                                      np.asarray(jls.slot_w))
        np.testing.assert_array_equal(ls.slot_aw.numpy(),
                                      np.asarray(jls.slot_aw))
        np.testing.assert_array_equal(ls.scales.numpy(),
                                      np.asarray(jls.scales))
        live = ls.slot_w.numpy() != 0
        pos = ls.slot_pos.numpy()
        np.testing.assert_array_equal(pos[live],
                                      np.asarray(jls.slot_pos)[live])
        if compacted:
            assert (pos[~live] == S.PARKED_POS).all()
            assert S.PARKED_POS == JS.PARKED_POS >= max(caps)
        # a live slot names the position of its neighbour in the input field
        f_in, f_out = got.fields[l].numpy(), got.fields[l + 1].numpy()
        assert (pos[live] < len(f_in)).all()
        np.testing.assert_array_equal(f_in[:len(f_out)], f_out)   # prefix
    if compacted:
        for f in got.fields:
            real = f.numpy()[f.numpy() < n]
            assert len(set(real)) == len(real)            # each id once


def test_schedule_dedup_default_and_own_draws(graphs):
    """With its own sampler the dedup schedule keeps its invariants: the
    default is dedup, a live slot's position holds the sampled neighbour,
    every sampled neighbour is a graph neighbour."""
    ds, _, tg = graphs
    n = ds.num_data
    batch = _batch(np.random.default_rng(42), ds, 30, 2)
    pack = S.schedule(torch.Generator().manual_seed(3), tg, T(batch), (2, 2),
                      cv=True)
    assert [f.shape[0] for f in pack.fields] == \
        S.field_capacities(32, (2, 2), n, tg.pad_degree, dedup=True)
    nbr = tg.nbr.numpy()
    for l, ls in enumerate(pack.layers):
        f_in, f_out = pack.fields[l].numpy(), pack.fields[l + 1].numpy()
        pos, w = ls.slot_pos.numpy(), ls.slot_w.numpy()
        for r in range(len(f_out)):
            for p, wt in zip(pos[r], w[r]):
                if wt != 0:
                    assert f_in[p] in nbr[f_out[r]]
                else:
                    assert p == S.PARKED_POS


# ------------------------------ the layers --------------------------------

def _dense_params(rng, d_in, d_out, norm):
    p = {"weights": rng.normal(size=(d_in, d_out)).astype(np.float32) * 0.3}
    if norm:
        p["offset"] = rng.normal(size=(1, d_out)).astype(np.float32) * 0.1
        p["scale"] = 1.0 + rng.normal(size=(1, d_out)).astype(np.float32) * 0.1
    return p


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _tp(p):
    return {k: T(v) for k, v in p.items()}


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("keep_prob", [1.0, 0.7])
@pytest.mark.parametrize("pair", [True, False])
def test_aug_dropout_dense_matches_jax(shared_noise, norm, keep_prob, pair):
    rng = np.random.default_rng(43)
    p = _dense_params(rng, WIDTH, 9, norm)
    x = rng.normal(size=(14, WIDTH)).astype(np.float32)
    x[-2:] = 0.0                                   # sentinel rows
    mu = rng.normal(size=(14, WIDTH)).astype(np.float32)
    jin = (jnp.asarray(x), jnp.asarray(mu)) if pair else jnp.asarray(x)
    tin = (T(x).requires_grad_(), T(mu).requires_grad_()) if pair \
        else T(x).requires_grad_()
    want = JL.aug_dropout_dense(_jp(p), jax.random.PRNGKey(0), jin, keep_prob,
                                JL.relu, norm)
    tparams = {k: v.requires_grad_() for k, v in _tp(p).items()}
    got = L.aug_dropout_dense(tparams, torch.Generator(), tin, keep_prob,
                              L.relu, norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(N(g), np.asarray(w), **TOL)
    assert got[0].requires_grad and not got[1].requires_grad   # mu detached


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("keep_prob", [1.0, 0.8])
@pytest.mark.parametrize("pair", [True, False])
def test_det_dropout_fc_matches_jax_with_gradients(norm, keep_prob, pair):
    rng = np.random.default_rng(44)
    p = _dense_params(rng, WIDTH, 9, norm)
    mu = rng.normal(size=(14, WIDTH)).astype(np.float32)
    var = rng.uniform(0.0, 0.5, (14, WIDTH)).astype(np.float32)
    mu[-2:], var[-2:] = 0.0, 0.0                   # sentinel rows
    g = rng.normal(size=(2, 14, 9)).astype(np.float32)

    def jloss(params, mu_, var_):
        out = JL.det_dropout_fc(params, (mu_, var_) if pair else mu_,
                                keep_prob, norm)
        return sum(jnp.sum(o * gi) for o, gi in zip(out, g)), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        _jp(p), jnp.asarray(mu), jnp.asarray(var))
    tparams = {k: v.requires_grad_() for k, v in _tp(p).items()}
    tmu, tvar = T(mu).requires_grad_(), T(var).requires_grad_()
    got = L.det_dropout_fc(tparams, (tmu, tvar) if pair else tmu, keep_prob,
                           norm)
    for o, w in zip(got, want):
        assert np.isfinite(N(o)).all()
        np.testing.assert_allclose(N(o), np.asarray(w), **TOL)
    sum((o * T(gi)).sum() for o, gi in zip(got, g)).backward()
    for k in p:
        np.testing.assert_allclose(N(tparams[k].grad),
                                   np.asarray(jgrads[0][k]), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(N(tmu.grad), np.asarray(jgrads[1]), rtol=1e-4,
                               atol=1e-4)
    if pair:
        np.testing.assert_allclose(N(tvar.grad), np.asarray(jgrads[2]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("keep_prob", [1.0, 0.6])
@pytest.mark.parametrize("kind", ["cvd pair", "moments", "tensor"])
def test_dropout_layer_matches_jax(shared_noise, kind, keep_prob):
    rng = np.random.default_rng(45)
    a = rng.normal(size=(11, 6)).astype(np.float32)
    b = rng.uniform(0.0, 1.0, (11, 6)).astype(np.float32)
    cvd = kind == "cvd pair"
    jin = jnp.asarray(a) if kind == "tensor" else (jnp.asarray(a),
                                                   jnp.asarray(b))
    tin = T(a) if kind == "tensor" else (T(a), T(b))
    want = JL.dropout_layer(jax.random.PRNGKey(0), jin, keep_prob, cvd)
    got = L.dropout_layer(torch.Generator(), tin, keep_prob, cvd)
    np.testing.assert_allclose(N(got), np.asarray(want), **TOL)
    if keep_prob == 1.0 and kind != "moments":
        np.testing.assert_array_equal(N(got), a)


def test_dropout_layer_samples_the_moments():
    """Its own streams: a Gaussian sample of (mu, var), then inverted
    dropout.  Mean mu and variance (var + mu^2) / p - mu^2 per element,
    within 5 standard errors over 40,000 draws."""
    mu = torch.tensor([[0.5, -1.0, 2.0]]).expand(40000, 3)
    var = torch.tensor([[0.25, 1.0, 0.04]]).expand(40000, 3)
    p = 0.8
    x = L.dropout_layer(torch.Generator().manual_seed(5), (mu, var), p,
                        False)
    want_var = (var[0] + mu[0] ** 2) / p - mu[0] ** 2
    se = torch.sqrt(want_var / 40000)
    assert ((x.mean(0) - mu[0]).abs() < 5 * se).all()
    assert ((x.var(0) - want_var).abs() < 0.05 * want_var).all()
    # a padded-sparse input takes the layer's sparse branch: the moments of
    # the dense input it stands for
    dense = torch.tensor([[0.5, 0.0, -2.0], [0.0, 0.0, 0.0]])
    sparse = G.PaddedSparseFeatures(
        idx=torch.tensor([[2, 0], [3, 3]], dtype=torch.int32),
        val=torch.tensor([[-2.0, 0.5], [0.0, 0.0]]), dim=3)
    w = {"weights": torch.arange(6.0).reshape(3, 2) / 6}
    for got, want in zip(L.det_dropout_fc(w, sparse, 0.8, False),
                         L.det_dropout_fc(w, dense, 0.8, False)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_init_aliases_match_init_dense():
    for init in (L.init_aug_dense, L.init_det_dropout_fc):
        got = init(torch.Generator().manual_seed(2), 7, 5, True)
        want = L.init_dense(torch.Generator().manual_seed(2), 7, 5, True)
        assert sorted(got) == ["offset", "scale", "weights"]
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


# ----------------------------- the aggregators ----------------------------

def _agg_inputs(graphs, seed, hist_dtype):
    """A dedup pack with cross-term weights and sentinel padding, two
    streams on its input field (the second one nonnegative, tiny on
    sentinel rows) and two histories, the second nonnegative with zeros."""
    ds, jg, tg = graphs
    n = ds.num_data
    rng = np.random.default_rng(seed)
    jpack = JS.schedule(jax.random.PRNGKey(seed), jg,
                        jnp.asarray(_batch(rng, ds, 27, 5)), (3,), cv=True,
                        need_aw=True, dedup=True)
    c, d = jpack.fields[0].shape[0], 7
    a = rng.normal(size=(c, d)).astype(np.float32)
    b = rng.uniform(0.05, 1.0, (c, d)).astype(np.float32)
    sentinel = np.asarray(jpack.fields[0]) >= n
    a[sentinel], b[sentinel] = 0.0, 1e-10
    h0 = rng.normal(size=(248, d)).astype(np.float32)
    h1 = rng.uniform(0.0, 1.0, (248, d)).astype(np.float32)
    h1[rng.random(248) < 0.3] = 0.0
    h0[n], h1[n] = 1e3, 1e3                       # row N: garbage by design
    if hist_dtype == "bfloat16":                  # exactly representable
        h0, h1 = (N(T(h).to(torch.bfloat16)) for h in (h0, h1))
    g = rng.normal(size=(2, jpack.fields[1].shape[0], 2 * d)).astype(
        np.float32)
    return jpack, _to_torch_pack(jpack), a, b, h0, h1, g


def _hist(h, dtype):
    return (jnp.asarray(h).astype(getattr(jnp, dtype)),
            T(h).to(getattr(torch, dtype)))


@pytest.mark.parametrize("hist_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["graphsage", "gcn"])
@pytest.mark.parametrize("branch", ["cv", "cvd", "moments"])
def test_vr_aggregate_branches_match_jax_with_gradients(graphs, branch, norm,
                                                        hist_dtype):
    _, jg, tg = graphs
    jpack, pack, a, b, h0, h1, g = _agg_inputs(graphs, 46, hist_dtype)
    (jh0, th0), (jh1, th1) = _hist(h0, hist_dtype), _hist(h1, hist_dtype)
    width = (2 if norm == "graphsage" else 1) * a.shape[1]
    g = g[:, :, :width]
    single = branch == "cv"

    def jloss(a_, b_):
        out, new_h = JA.vr_aggregate(
            a_ if single else (a_, b_), jpack.layers[0], jpack.fields[0],
            jpack.fields[1], jg, (jh0, jh1), branch == "cvd", norm)
        outs = (out,) if single else out
        return sum(jnp.sum(o * gi) for o, gi in zip(outs, g)), (outs, new_h)

    (_, (want, want_h)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(a), jnp.asarray(b))
    ta, tb = T(a).requires_grad_(), T(b).requires_grad_()
    out, new_h = A.vr_aggregate(
        ta if single else (ta, tb), pack.layers[0], pack.fields[0],
        pack.fields[1], tg, (th0, th1), branch == "cvd", norm)
    outs = (out,) if single else out
    assert len(outs) == len(want) and len(new_h) == len(want_h)
    for o, w in zip(outs, want):
        assert np.isfinite(N(o)).all()
        np.testing.assert_allclose(N(o), np.asarray(w), **TOL)
    for h, w in zip(new_h, want_h):
        np.testing.assert_array_equal(N(h), np.asarray(w))
    sum((o * T(gi)).sum() for o, gi in zip(outs, g)).backward()
    np.testing.assert_allclose(N(ta.grad), np.asarray(jgrads[0]), **TOL)
    if not single:
        np.testing.assert_allclose(N(tb.grad), np.asarray(jgrads[1]), **TOL)


@pytest.mark.parametrize("norm", ["graphsage", "gcn"])
@pytest.mark.parametrize("moments", [False, True])
def test_plain_aggregate_branches_match_jax_with_gradients(graphs, moments,
                                                           norm):
    jpack, pack, a, b, _, _, g = _agg_inputs(graphs, 47, "float32")
    width = (2 if norm == "graphsage" else 1) * a.shape[1]
    g = g[:, :, :width]

    def jloss(a_, b_):
        out = JA.plain_aggregate((a_, b_) if moments else a_,
                                 jpack.layers[0], norm)
        outs = out if moments else (out,)
        return sum(jnp.sum(o * gi) for o, gi in zip(outs, g)), outs

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = T(a).requires_grad_(), T(b).requires_grad_()
    out = A.plain_aggregate((ta, tb) if moments else ta, pack.layers[0],
                            norm)
    outs = out if moments else (out,)
    for o, w in zip(outs, want):
        np.testing.assert_allclose(N(o), np.asarray(w), **TOL)
    sum((o * T(gi)).sum() for o, gi in zip(outs, g)).backward()
    np.testing.assert_allclose(N(ta.grad), np.asarray(jgrads[0]), **TOL)
    if moments:
        np.testing.assert_allclose(N(tb.grad), np.asarray(jgrads[1]), **TOL)


def test_full_neighborhood_mean_square_matches_jax(graphs):
    ds, jg, tg = graphs
    rng = np.random.default_rng(48)
    field = _batch(rng, ds, 30, 3)
    hist = rng.uniform(0, 1, (248, WIDTH)).astype(np.float32)
    for square in (False, True):
        want = JA.full_neighborhood_mean(jnp.asarray(hist), jg,
                                         jnp.asarray(field), square=square)
        got = A.full_neighborhood_mean(T(hist), tg, T(field), square=square)
        np.testing.assert_allclose(N(got), np.asarray(want), **TOL)
    with pytest.raises(NotImplementedError, match="lazy"):
        A.vr_aggregate(T(hist), None, None, None, tg, (T(hist),), False,
                       "gcn", lazy_l=((), ()))


# ------------------------------ one train step ----------------------------

ESTIMATORS = {
    "cvd": dict(cv=True, cvd=True, test_cv=True, test_cvd=True, degree=2,
                field_dedup=True),
    "det_dropout": dict(cv=True, det_dropout=True, test_cv=True, degree=2),
    # Exact: exhaustive degree, no PP (the first layer is WIDTH wide), no
    # control variate; dedup is forced
    "exact": dict(cv=False, test_cv=False, degree=10000, preprocess=False,
                  test_preprocess=False),
    "cv_nopp": dict(cv=True, test_cv=True, degree=2, preprocess=False,
                    test_preprocess=False),
}


def _estimator_cfg(name, **over):
    return Config(**{**dict(batch_size=32, hidden1=16,
                            normalization="graphsage", layer_norm=True,
                            num_fc_layers=2, weight_decay=5e-4, dropout=0.2,
                            pad_degree=64, seed=1), **ESTIMATORS[name],
                     **over})


def _specs(cfg, ds):
    args = (ds.feature_dim, ds.num_classes, cfg.preprocess, cfg.cv, cfg.cvd)
    return JM.build_model_spec(cfg, *args), \
        M.build_model_spec(port_cfg(cfg), *args)


def _random_histories(rng, spec, n, dtype):
    """Per agg layer 1 or 2 histories of exactly representable values; the
    second (variances) nonnegative; row N garbage."""
    out = []
    for d in spec.history_dims:
        hs = []
        for j in range(spec.n_history_per_layer):
            h = rng.normal(size=(248, d)).astype(np.float32)
            h = np.abs(h) * 0.3 if j == 1 else h
            h[n] = 1e3
            hs.append(T(h).to(dtype))
        out.append(tuple(hs))
    return tuple(out) if spec.cv else ()


def _jax_histories(hists):
    return tuple(tuple(jnp.asarray(N(h)).astype(
        jnp.bfloat16 if h.dtype == torch.bfloat16 else jnp.float32)
        for h in hl) for hl in hists)


@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_train_step_of_each_estimator_matches_jax(graphs, shared_noise,
                                                  name):
    ds, jg, tg = graphs
    n = ds.num_data
    cfg = _estimator_cfg(name)
    jspec, spec = _specs(cfg, ds)
    degrees = (cfg.degree,) * spec.num_agg_layers
    feats = (np.hstack((ds.feats, ds.train_feats)) if cfg.preprocess
             else ds.feats).astype(np.float32)
    rng = np.random.default_rng(49)
    hists = _random_histories(rng, spec, n, torch.bfloat16)
    batch = _batch(rng, ds, 28, 4)
    jpack = JS.schedule(jax.random.PRNGKey(3), jg, jnp.asarray(batch),
                        degrees, cv=cfg.cv, need_aw=cfg.det_dropout,
                        dedup=cfg.field_dedup)
    if name == "exact":                           # forced, not asked for
        assert not cfg.field_dedup and jpack.fields[0].shape[0] == \
            S.field_capacities(32, degrees, n, tg.pad_degree, dedup=True)[0]

    jparams = JM.init_params(jax.random.PRNGKey(4), jspec)
    jstate = JStep.TrainState(
        params=jparams, opt_state=JStep.make_optimizer(cfg).init(jparams),
        histories=_jax_histories(hists), step=jnp.zeros((), jnp.int32))
    jstep = JStep.build_train_step(cfg, jspec, degrees, n)
    jstate, jm = jstep(jstate, jg, JG.dense_rows(feats, n),
                       JG.dense_rows(ds.labels, n), jnp.zeros((n + 1,)),
                       jnp.asarray(batch), jax.random.PRNGKey(0), pack=jpack)

    params = C.params_from_jax(_np_tree(jparams))
    pcfg = port_cfg(cfg)
    state = St.TrainState(
        params=params, opt_state=St.make_optimizer(pcfg).init(params),
        histories=tuple(tuple(h.clone() for h in hl) for hl in hists),
        step=torch.zeros((), dtype=torch.int32))
    step = St.build_train_step(pcfg, spec, degrees, n)
    state, m = step(state, tg, G.dense_rows(feats, n),
                    G.dense_rows(ds.labels, n), T(batch), torch.Generator(),
                    pack=_to_torch_pack(jpack))

    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               **STEP_TOL)
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]),
                               **STEP_TOL)
    jopt = jstate.opt_state[0]
    for l, k in St.param_keys(params):
        # after one update mu = (1 - b1) * grad exactly: the gradients
        np.testing.assert_allclose(
            N(state.opt_state.mu[l][k]) / (1 - cfg.beta1),
            np.asarray(jopt.mu[l][k]) / (1 - cfg.beta1), **STEP_TOL)
        np.testing.assert_allclose(N(state.params[l][k]),
                                   np.asarray(jstate.params[l][k]),
                                   **STEP_TOL)
    assert len(state.histories) == len(jstate.histories)
    for hl, jhl, old in zip(state.histories, jstate.histories, hists):
        assert len(hl) == len(jhl) == spec.n_history_per_layer
        for h, jh, o in zip(hl, jhl, old):
            want = np.asarray(jh.astype(jnp.float32))
            ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
            # one bf16 ulp, and the tolerance of the step under it
            assert (np.abs(N(h) - want) <= ulp + 1e-4).all()
            assert (N(h) != N(o)).any()           # the scatter happened
    assert int(m["amt_data"]) == int(jm["amt_data"])
    for k in ("field_sizes", "adj_sizes", "fadj_sizes"):
        np.testing.assert_array_equal(N(m[k]).astype(np.int64),
                                      np.asarray(jm[k]))


@pytest.mark.parametrize("name", ["cvd", "det_dropout", "cv_nopp"])
@pytest.mark.parametrize("train_mode", [True, False])
def test_pred_and_grad_matches_jax(graphs, shared_noise, name, train_mode):
    """Exhaustive degree, so both packages schedule the same fields; the
    dropout masks are shared."""
    ds, jg, tg = graphs
    n = ds.num_data
    cfg = _estimator_cfg(name, degree=10000, test_degree=10000,
                         batch_size=16)
    jspec, spec = _specs(cfg, ds)
    degrees = (10000,) * spec.num_agg_layers
    feats = (np.hstack((ds.feats, ds.train_feats)) if cfg.preprocess
             else ds.feats).astype(np.float32)
    rng = np.random.default_rng(50)
    hists = _random_histories(rng, spec, n, torch.float32)
    batch = _batch(rng, ds, 14, 2)
    jparams = JM.init_params(jax.random.PRNGKey(5), jspec)
    want_p, want_g = JStep.build_pred_and_grad(cfg, jspec, degrees, n,
                                               train_mode)(
        jparams, _jax_histories(hists), jg, JG.dense_rows(feats, n),
        JG.dense_rows(ds.labels, n), jnp.zeros((n + 1,)), jnp.asarray(batch),
        jax.random.PRNGKey(0))
    params = C.params_from_jax(_np_tree(jparams))
    got_p, got_g = St.build_pred_and_grad(port_cfg(cfg), spec, degrees, n,
                                          train_mode)(
        params, hists, tg, G.dense_rows(feats, n),
        G.dense_rows(ds.labels, n), T(batch), torch.Generator())
    first = M.first_param_layer(spec)
    assert tuple(got_g.shape) == tuple(params[first]["weights"].shape)
    assert not any(t.requires_grad for p in params.values()
                   for t in p.values())           # the caller's params
    np.testing.assert_allclose(N(got_p), np.asarray(want_p), **STEP_TOL)
    np.testing.assert_allclose(N(got_g), np.asarray(want_g), **STEP_TOL)


# ------------------------------- Polyak -----------------------------------

def test_polyak_average_after_three_steps_matches_jax(graphs):
    ds, jg, tg = graphs
    n = ds.num_data
    cfg = Config(batch_size=32, degree=1, cv=True, test_cv=True, hidden1=16,
                 normalization="graphsage", layer_norm=True, num_fc_layers=2,
                 weight_decay=5e-4, dropout=0.0, pad_degree=64, seed=1,
                 polyak_decay=0.9, field_dedup=True)   # each id once: the
    # history scatter has no duplicate writes to race
    jspec, spec = _specs(cfg, ds)
    feats = np.hstack((ds.feats, ds.train_feats)).astype(np.float32)
    rng = np.random.default_rng(51)
    jparams = JM.init_params(jax.random.PRNGKey(4), jspec)
    jstate = JStep.TrainState(
        params=jparams, opt_state=JStep.make_optimizer(cfg).init(jparams),
        histories=JM.init_histories(jspec, n, 8, jnp.bfloat16),
        step=jnp.zeros((), jnp.int32),
        avg_params=jax.tree_util.tree_map(jnp.copy, jparams))
    pcfg = port_cfg(cfg)
    state = St.init_train_state(torch.Generator().manual_seed(0), pcfg, spec,
                                n)
    assert state.avg_params is not None
    assert St.init_train_state(torch.Generator(), port_cfg(
        cfg.replace(polyak_decay=0.0)), spec, n).avg_params is None
    init = C.params_from_jax(_np_tree(jparams))
    for l, k in St.param_keys(init):
        state.params[l][k].copy_(init[l][k])
        state.avg_params[l][k].copy_(init[l][k])
    jstep = JStep.build_train_step(cfg, jspec, (1,), n)
    step = St.build_train_step(pcfg, spec, (1,), n)
    for i in range(3):
        batch = _batch(rng, ds, 32, 0)
        jpack = JS.schedule(jax.random.PRNGKey(10 + i), jg,
                            jnp.asarray(batch), (1,), cv=True, dedup=True)
        jstate, _ = jstep(jstate, jg, JG.dense_rows(feats, n),
                          JG.dense_rows(ds.labels, n), jnp.zeros((n + 1,)),
                          jnp.asarray(batch), jax.random.PRNGKey(0),
                          pack=jpack)
        state, _ = step(state, tg, G.dense_rows(feats, n),
                        G.dense_rows(ds.labels, n), T(batch),
                        torch.Generator(), pack=_to_torch_pack(jpack))
    for l, k in St.param_keys(state.params):
        np.testing.assert_allclose(N(state.avg_params[l][k]),
                                   np.asarray(jstate.avg_params[l][k]),
                                   rtol=0, atol=1e-5)
        assert (N(state.avg_params[l][k]) != N(state.params[l][k])).any()


def test_polyak_eval_params_and_checkpoints_cross_load(tmp_path):
    """Evaluation uses the average; ``avg_params`` crosses to JAX and back;
    the reconcile rule holds in the port as in JAX."""
    cfg = _flags(tmp_path / "port", "--polyak_decay", "0.9", "--dropout",
                 "0")
    ds = Ld.load_data(port_cfg(cfg))
    tt = Trainer(port_cfg(cfg), ds, device="cpu")
    tt.train_epoch()
    assert tt._eval_params() is tt.state.avg_params
    tt.save()
    # port -> JAX
    jt = JaxTrainer(cfg, ds)
    jt.load()
    for l, k in St.param_keys(tt.params):
        np.testing.assert_array_equal(np.asarray(jt.state.avg_params[l][k]),
                                      N(tt.state.avg_params[l][k]))
    ids = np.asarray(ds.test_d)
    np.testing.assert_allclose(tt.predict(ids), jt.predict(ids), rtol=0,
                               atol=1e-5)
    # the prediction is the average's, not the raw weights'
    raw = Trainer(port_cfg(cfg.replace(polyak_decay=0.0)), ds, device="cpu")
    raw.load()                     # a saved average is ignored
    assert raw.state.avg_params is None and raw._eval_params() is raw.params
    assert np.abs(raw.predict(ids) - tt.predict(ids)).max() > 1e-6
    # JAX -> port
    jcfg = cfg.replace(ckpt_dir=str(tmp_path / "jax"))
    jt = JaxTrainer(jcfg, ds)
    jt.train_epoch()
    jt.save()
    jt.finish_checkpoints()
    back = Trainer(port_cfg(jcfg), ds, device="cpu")
    back.load()
    for l, k in St.param_keys(back.params):
        np.testing.assert_array_equal(N(back.state.avg_params[l][k]),
                                      np.asarray(jt.state.avg_params[l][k]))
        np.testing.assert_array_equal(N(back.params[l][k]),
                                      np.asarray(jt.state.params[l][k]))
    # a run that keeps an average, from a checkpoint without one: seeded
    # from the restored weights
    raw.save()
    seeded = Trainer(port_cfg(cfg.replace(ckpt_dir=raw.cfg.ckpt_dir)), ds,
                     device="cpu")
    seeded.load()
    for l, k in St.param_keys(seeded.params):
        torch.testing.assert_close(seeded.state.avg_params[l][k],
                                   raw.params[l][k], rtol=0, atol=0)


def test_det_dropout_checkpoint_with_two_histories_cross_loads(tmp_path):
    cfg = _flags(tmp_path / "port", "--det_dropout")
    ds = Ld.load_data(port_cfg(cfg))
    tt = Trainer(port_cfg(cfg), ds, device="cpu")
    assert [len(hl) for hl in tt.state.histories] == [2]
    assert [len(hl) for hl in tt.eval_histories] == [2]
    tt.train_epoch()
    tt.evaluate(ds.val_d)
    tt.save()
    jt = JaxTrainer(cfg, ds)
    jt.load(load_history=True)
    for j in range(2):
        np.testing.assert_array_equal(
            np.asarray(jt.state.histories[0][j].astype(jnp.float32)),
            N(tt.state.histories[0][j]))
    assert float(jnp.abs(jt.state.histories[0][1].astype(
        jnp.float32)).sum()) > 0
    jcfg = cfg.replace(ckpt_dir=str(tmp_path / "jax"))
    jt = JaxTrainer(jcfg, ds)
    jt.train_epoch()
    jt.save()
    jt.finish_checkpoints()
    back = Trainer(port_cfg(jcfg), ds, device="cpu")
    back.load(load_history=True)
    for j in range(2):
        np.testing.assert_array_equal(
            N(back.state.histories[0][j]),
            np.asarray(jt.state.histories[0][j].astype(jnp.float32)))


# -------------------------- gradient variance -----------------------------

def test_stat_matches_jax():
    rng = np.random.default_rng(52)
    vals = rng.normal(size=(5, 3, 4)).astype(np.float32)
    want, got = JMet.Stat(), Met.Stat()
    for v in vals:
        want.add(v)
        got.add(T(v))
    np.testing.assert_array_equal(got.mean(), want.mean())
    np.testing.assert_array_equal(got.std(), want.std())


GRADVAR_KEYS = {"pred_bias", "grad_bias", "pred_stdev", "grad_stdev",
                "full_pred_stdev", "full_grad_stdev"}


def test_gradient_variance_without_dropout(tmp_path):
    """Exhaustive test degree and no dropout: the full model is
    deterministic (zero stdev); the degree-1 CV estimator is not."""
    cfg = _flags(tmp_path, "--gradvar", "--dropout", "0", "--degree", "1",
                 "--test_degree", "10000", "--history_dtype", "float32")
    ds = Ld.load_data(port_cfg(cfg))
    tr = Trainer(port_cfg(cfg), ds, device="cpu")
    # --gradvar evaluates on the train graph
    torch.testing.assert_close(tr.graph_full.nbr, tr.graph_train.nbr)
    torch.testing.assert_close(tr.test_features, tr.train_features)
    tr.train_epoch()
    lines = []
    out = tr.gradient_variance(times=8, log=lines.append)
    assert set(out) == GRADVAR_KEYS
    assert all(np.isfinite(v) for v in out.values()), out
    # zero but for the rounding of a float32 mean of equal values
    assert out["full_pred_stdev"] < 1e-6 and out["full_grad_stdev"] < 1e-6
    assert out["grad_stdev"] > 0.0
    assert [s.split(" = ")[0] for s in lines] == [
        "Full pred stdev", "Full grad stdev", "Part pred bias",
        "Part pred stdev", "Part grad bias", "Part grad stdev"]


def test_gradient_variance_of_converged_cv_is_unbiased(tmp_path):
    """With histories converged on the same weights and graph (the harness's
    protocol) and no dropout, the CV estimator's predictions equal the
    exact ones: its bias and stdev vanish."""
    cfg = _flags(tmp_path, "--gradvar", "--dropout", "0", "--degree", "1",
                 "--test_degree", "10000", "--history_dtype", "float32")
    ds = Ld.load_data(port_cfg(cfg))
    tr = Trainer(port_cfg(cfg), ds, device="cpu")
    tr.train_epoch()
    for _ in range(cfg.num_layers + 1):
        tr.evaluate(np.arange(ds.num_data))
    for t, e in zip(tr.state.histories[0], tr.eval_histories[0]):
        t.copy_(e)
    out = tr.gradient_variance(times=8, log=lambda s: None)
    assert out["pred_bias"] < 1e-5 and out["pred_stdev"] < 1e-5, out


def test_load_restores_histories_under_gradvar(tmp_path):
    cfg = _flags(tmp_path, "--gradvar")
    ds = Ld.load_data(port_cfg(cfg))
    tr = Trainer(port_cfg(cfg), ds, device="cpu")
    tr.train_epoch()
    tr.save()
    want = tr.state.histories[0][0].clone()
    for gradvar, restored in ((True, True), (False, False)):
        other = Trainer(port_cfg(cfg.replace(gradvar=gradvar)), ds,
                        device="cpu")
        other.load()
        assert torch.equal(other.state.histories[0][0], want) is restored


def test_cli_dispatches_gradvar(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(Trainer, "gradient_variance",
                        lambda self, *a, **k: calls.append(self.cfg.gradvar))
    common = FLAGS + ["--epochs", "0", "--device", "cpu"]
    train_cli.main(common + ["--ckpt_dir", str(tmp_path / "a"), "--gradvar"])
    assert calls == [True]
    train_cli.main(common + ["--ckpt_dir", str(tmp_path / "b")])
    assert calls == [True]


# ------------------------- whole runs of the port -------------------------

@pytest.mark.parametrize("flags", [
    ["--cvd", "--test_cvd"], ["--det_dropout"], ["--field_dedup"],
    ["--nopreprocess", "--notest_preprocess"],
    ["--nocv", "--notest_cv", "--degree", "10000", "--test_degree", "10000",
     "--nopreprocess", "--notest_preprocess"],
    ["--polyak_decay", "0.99"]])
def test_ported_flags_train_and_evaluate(tmp_path, flags):
    cfg = _flags(tmp_path, *flags)
    ds = Ld.load_data(port_cfg(cfg))
    tr = Trainer(port_cfg(cfg), ds, device="cpu")
    first = tr.evaluate(ds.val_d)[0]
    for _ in range(3):
        loss = tr.train_epoch()[0]
    assert np.isfinite(loss)
    last = tr.evaluate(ds.val_d)
    assert np.isfinite(last[0]) and last[0] < first


def test_det_dropout_with_importance_raises_as_in_jax(tmp_path):
    cfg = _flags(tmp_path, "--det_dropout", "--importance")
    ds = Ld.load_data(port_cfg(cfg.replace(importance=False)))
    with pytest.raises(ValueError, match="incompatible"):
        JaxTrainer(cfg, ds)
    with pytest.raises(ValueError, match="incompatible"):
        Trainer(port_cfg(cfg), ds, device="cpu")


def test_sampled_cvd_accuracy_matches_jax(tmp_path):
    """degree 1, dropout 0.2: the sampling and dropout streams differ, so
    the runs are held by their outcome, val micro-F1 over 2 seeds."""
    ds = Ld.community_sbm_dataset(num_nodes=1024, num_classes=4,
                                  feature_dim=18, mean_degree=12, p_in=0.8,
                                  snr=0.35, max_degree=16, val_frac=0.3,
                                  seed=0)
    f1 = {"jax": [], "port": []}
    for seed in (1, 2):
        cfg = Config(dataset="sbm", batch_size=64, degree=1, test_degree=1,
                     cv=True, cvd=True, test_cv=True, test_cvd=True,
                     hidden1=16, normalization="graphsage", layer_norm=True,
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
    assert abs(mean["port"] - mean["jax"]) <= 0.05, f1
