"""Every generator is a function of the seed alone."""
from __future__ import annotations

import numpy as np
import torch

from bench import datagen, harness
from bench.drivers import fit, fit_sharded, stream
from conftest import make_small_root

BIG = 2 ** 31 + 12345


def ctx_for(root, workload, seed):
    cell = harness.cell(harness.load_spec(root), workload, root)
    return harness.Context(cell, seed, 1.0, False, "cpu", 0.0)


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_fit_data_is_the_seeds(tmp_path):
    root = make_small_root(tmp_path)
    a = fit.datasets(ctx_for(root, "dsml-reg.fit", BIG))
    b = fit.datasets(ctx_for(root, "dsml-reg.fit", BIG))
    c = fit.datasets(ctx_for(root, "dsml-reg.fit", BIG + 1))
    assert all(same(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0].Xs, c[0].Xs)


def test_sharded_blocks_share_the_support(tmp_path):
    root = make_small_root(tmp_path)
    ctx = ctx_for(root, "dsml-reg.fit-4chip", BIG)
    world, m = ctx.cell.traffic["ranks"], ctx.cell.config["m"]
    blocks = [fit_sharded.block_sets(ctx, r, world, "cpu")
              for r in range(world)]
    again = fit_sharded.block_sets(ctx, 2, world, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(blocks[2][0], again[0]))
    whole = datagen.regression(datagen.generator(BIG, "cpu"),
                               ctx.cell.config, m=m * world)
    assert torch.equal(torch.cat([b[0][0] for b in blocks]), whole.Xs)


def test_stream_pool_is_the_seeds(tmp_path):
    root = make_small_root(tmp_path)
    ctx = ctx_for(root, "dsml-stream.ingest-serve", BIG)
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    a, ra = stream.make_pool(datagen.generator(BIG, "cpu"), cfg, tr)
    b, rb = stream.make_pool(datagen.generator(BIG, "cpu"), cfg, tr)
    c, _ = stream.make_pool(datagen.generator(BIG + 1, "cpu"), cfg, tr)
    assert all(same(x, y) for x, y in zip(a, b)) and torch.equal(ra, rb)
    assert not torch.equal(a[0][0], c[0][0])


def test_arrivals_are_one_set_in_the_seeds_order():
    a = datagen.permuted_gaps(BIG, 500.0, 1000)
    b = datagen.permuted_gaps(BIG, 500.0, 1000)
    c = datagen.permuted_gaps(BIG + 1, 500.0, 1000)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(np.sort(a), np.sort(c))


def test_ar_design_has_the_stated_covariance():
    L = datagen.ar_factor(6, 0.5, "cpu").double()
    idx = torch.arange(6, dtype=torch.float64)
    want = 0.5 ** torch.abs(idx[:, None] - idx[None, :])
    assert torch.allclose(L @ L.T, want, atol=1e-6)
