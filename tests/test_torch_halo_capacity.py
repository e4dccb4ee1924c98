"""The port's halo transports (parallel/halo.py) against the JAX
package's, on gloo groups of 2 and 4 ranks (one spawn each, every case
through ``checks.run_jobs``) and on one process: the history scatter's
static capacity, the gathers, and world 1.

Every rank takes its slice of one global id list, as a sharded program
does; JAX's ``row_scatter`` runs on the first 2 or 4 virtual devices.
Tolerances: the scatters' tables bitwise and their dropped counts equal;
the gathers (float32, bfloat16, the int32 / float32 pair) bitwise against
``table[ids]``, their gradients within 1e-5 of the whole-table gradient
(float32 sums in another order).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.parallel import halo as JH
from stochastic_gcn_tpu.parallel.mesh import make_mesh as jax_mesh

from stochastic_gcn_tpu_torch.config import Config
from stochastic_gcn_tpu_torch.parallel import checks, halo, launch
from stochastic_gcn_tpu_torch.parallel import mesh as PM

ROWS_PER_RANK, D, IDS_PER_RANK = 128, 4, 16
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(p: int) -> dict:
    """The scatter and gather cases at world ``p``: ``[P * c]`` id lists
    of a ``[P * 128, 4]`` float32 table, ``c = 16`` a rank."""
    rng = np.random.default_rng(100 + p)
    r, c = ROWS_PER_RANK * p, IDS_PER_RANK * p
    n_loc, c_loc = ROWS_PER_RANK, IDS_PER_RANK
    sentinel = r - 3
    table = rng.normal(size=(r, D)).astype(np.float32)
    rows = rng.normal(size=(c, D)).astype(np.float32)
    # all in rank 0's block; each rank's slice is rank q's writes
    skew = rng.permutation(n_loc)[:c]
    local = np.concatenate([q * n_loc + rng.permutation(n_loc)[:c_loc]
                            for q in range(p)])
    with_sentinel = np.concatenate([np.r_[
        rng.permutation(n_loc)[:4] + ((q + 1) % p) * n_loc,
        [sentinel] * 6, [1 << 30] * (c_loc - 10)] for q in range(p)])
    scatters = {
        "uniform_2": (rng.permutation(sentinel)[:c], 2.0),
        "skew_1": (skew, 1.0),
        "skew_0.01": (skew, 0.01),
        "local_0.01": (local, 0.01),
        "sentinel_0.01": (with_sentinel, 0.01),
    }
    gathers = {
        "skewed": rng.integers(0, n_loc, size=c),
        "uniform": rng.integers(0, r, size=c),
        "aligned": local,
        "repeated": np.repeat(rng.integers(0, r, size=p), c_loc),
    }
    arrays = {}
    for name, (ids, mult) in scatters.items():
        pre = f"scatter:{name}"
        arrays.update({f"{pre}:table": table, f"{pre}:rows": rows,
                       f"{pre}:ids": ids.astype(np.int32),
                       f"{pre}:mult": np.float64(mult),
                       f"{pre}:sentinel": np.int64(sentinel)})
    for name, ids in gathers.items():
        pre = f"gather:{name}"
        arrays.update({f"{pre}:table": table,
                       f"{pre}:ids": ids.astype(np.int32),
                       f"{pre}:coef": rng.normal(size=(c, D)).astype(
                           np.float32)})
    return arrays


def _spawned(root, p: int):
    arrays = _inputs(p)
    np.savez(root / "in.npz", **arrays)
    jobs = [("halo_runs", (str(root / "in.npz"), str(root / "out.npz")))]
    if p == 2:
        jobs.append(("scatter_no_host_read", (str(root / "read.npz"),)))
    launch.spawn(checks.run_jobs, p, (jobs,), "cpu", store_dir=str(root))
    got = dict(np.load(root / "out.npz"))
    if p == 2:
        got.update({f"read:{k}": v for k, v in
                    np.load(root / "read.npz").items()})
    return arrays, got


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {p: _spawned(tmp_path_factory.mktemp(f"w{p}"), p) for p in (2, 4)}


@pytest.mark.parametrize("c,p,cap_mult", [
    (96, 2, 0.25), (96, 2, 2.0), (512, 4, 2.0), (512, 4, 0.5),
    (8192, 4, 2.0), (8192, 8, 1.0), (30, 3, 0.01), (64, 4, 4.0),
    (1000, 8, 2.5), (0, 2, 2.0)])
def test_scatter_capacity_matches_jax(c, p, cap_mult):
    assert halo.scatter_capacity(c, p, cap_mult) == \
        JH.scatter_capacity(c, p, cap_mult)


@pytest.mark.parametrize("exchange", [True, False])
@pytest.mark.parametrize("mult", [2.0, 0.25])
def test_halo_spec_carries_the_scatter_transport(exchange, mult):
    """The Trainer's mesh takes ``--halo_exchange`` and
    ``--scatter_cap_mult`` from the config; without a mesh there is
    none."""
    cfg = Config(halo_exchange=exchange, scatter_cap_mult=mult)
    mesh = halo.halo_spec(cfg, PM.Mesh(rank=0, size=2))
    assert (mesh.halo_exchange, mesh.scatter_cap_mult) == (exchange, mult)
    assert halo.halo_spec(cfg, None) is None


@pytest.mark.parametrize("name", ["uniform_2", "skew_1", "skew_0.01",
                                  "local_0.01", "sentinel_0.01"])
@pytest.mark.parametrize("p", [2, 4])
def test_row_scatter_matches_jax(worlds, p, name):
    arrays, got = worlds[p]
    pre = f"scatter:{name}"
    mesh = jax_mesh(p)
    out, dropped = jax.jit(lambda t, i, x: JH.row_scatter(
        t, i, x, mesh, cap_mult=float(arrays[f"{pre}:mult"]),
        sentinel=int(arrays[f"{pre}:sentinel"])))(
        jnp.asarray(arrays[f"{pre}:table"]), jnp.asarray(arrays[f"{pre}:ids"]),
        jnp.asarray(arrays[f"{pre}:rows"]))
    np.testing.assert_array_equal(got[f"{pre}:table"], np.asarray(out))
    assert int(got[f"{pre}:dropped"]) == int(dropped)
    if name.startswith("skew"):
        assert int(dropped) > 0
    if name.startswith(("local", "sentinel")):
        assert int(dropped) == 0


@pytest.mark.parametrize("name", ["skewed", "uniform", "aligned",
                                  "repeated"])
@pytest.mark.parametrize("p", [2, 4])
def test_row_gather_is_exact(worlds, p, name):
    arrays, got = worlds[p]
    pre = f"gather:{name}"
    table, ids = arrays[f"{pre}:table"], arrays[f"{pre}:ids"]
    np.testing.assert_array_equal(got[f"{pre}:float32"], table[ids])
    bf16 = np.asarray(jnp.asarray(table, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got[f"{pre}:bfloat16"], bf16[ids])
    np.testing.assert_array_equal(got[f"{pre}:int32"],
                                  table.astype(np.int32)[ids])
    np.testing.assert_array_equal(got[f"{pre}:pair_f"], table[ids])
    want = np.zeros_like(table)
    np.add.at(want, ids, arrays[f"{pre}:coef"])
    np.testing.assert_allclose(got[f"{pre}:grad"], want, **GRAD_TOL)


def test_scatter_makes_no_host_read(worlds):
    """``checks.scatter_no_host_read`` ran a dropping scatter at world 2
    with ``tolist``, ``item``, ``cpu``, ``numpy`` and the scalar
    conversions raising; the count read after is 16 (of rank 1's 32
    remote writes, capacity 16)."""
    _, got = worlds[2]
    assert int(got["read:dropped"]) == 16


def test_world_one_routes_nothing(monkeypatch):
    """A data group of one rank: gathers, the pair gather, a scatter, the
    gradient and the owner-routed contraction call no collective and put
    nothing on the wire, and equal the plain operations."""
    import torch
    import torch.distributed as dist

    def refuse(*_, **__):
        raise AssertionError("a collective at world 1")
    for name in ("all_to_all_single", "all_reduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "all_gather_single",
                 "reduce_scatter_single"):
        monkeypatch.setattr(dist, name, refuse, raising=False)
    monkeypatch.setattr(PM, "_all_gather", refuse)
    monkeypatch.setattr(PM, "_reduce_scatter", refuse)
    mesh = PM.Mesh(rank=0, size=1)
    PM.reset_wire()
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    ids = torch.from_numpy(np.r_[rng.integers(0, 37, 20), [37, 1 << 30]]
                           ).to(torch.int32)
    live = (ids < 37)[:, None]
    want = torch.where(live, table[ids.clamp(max=39).long()], 0.0)
    assert torch.equal(halo.row_gather(table, ids, mesh, 37), want)
    gi, gf = halo.row_gather2(table.to(torch.int32), table, ids, mesh, 37)
    assert torch.equal(gi, torch.where(live, table.to(torch.int32)[
        ids.clamp(max=39).long()], 0)) and torch.equal(gf, want)
    leaf = table.clone().requires_grad_()
    halo.row_gather(leaf, ids, mesh, 37).sum().backward()
    grad = torch.zeros_like(table).index_add_(
        0, ids[ids < 37].long(), torch.ones(int((ids < 37).sum()), 3))
    assert torch.equal(leaf.grad, grad)
    target = table.clone()
    uniq = torch.tensor([5, 9, 37, 1 << 30, 2], dtype=torch.int32)
    new = torch.ones(5, 3)
    _, dropped = halo.row_scatter(target, uniq, new, dataclasses.replace(
        mesh, scatter_cap_mult=0.01), 37)
    want_t = table.clone()
    want_t[[5, 9, 2]] = 1.0
    assert torch.equal(target, want_t) and int(dropped) == 0
    got = halo.owner_routed(table, ids.reshape(-1, 2).long(), (),
                            lambda t, loc, mine: t.index_select(
                                0, loc.reshape(-1).clamp(max=39)).float(),
                            mesh)
    assert got.shape == (22, 3)
    assert sum(PM.WIRE.values()) == 0
