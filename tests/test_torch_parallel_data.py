"""The data path of the port's data parallelism (`migan_tpu_torch/data/
sampler.py`: `ShardSampler`, `InfiniteSampler(block=...)`, the
`DataLoader`'s `position_stride` / `position_block`) against the JAX
package's (`migan_tpu/data/sampler.py`), index for index and position for
position, as `tests/test_multihost.py` holds the JAX package's own; and
the block-sharded stream against the single-process stream, for a dataset
size that does not divide the batch and a resumed start. Also
`parallel.maybe_initialize_distributed`: a no-op without the launcher's
env, a refusal of `cuda` without a card and of a partial env."""

import itertools

import numpy as np
import pytest

from migan_tpu.data import sampler as js
from migan_tpu_torch.data import sampler as ts


@pytest.mark.parametrize("n,shards,shuffle,extend", [
    (103, 4, False, True), (103, 4, True, False), (64, 8, True, False),
    (5, 2, False, True), (10, 3, True, True)])
def test_shard_sampler_matches_jax(n, shards, shuffle, extend):
    for shard in range(shards):
        for epoch in (0, 3):
            want = js.ShardSampler(n, shards, shard, shuffle=shuffle, seed=3,
                                   extend=extend).epoch_indices(epoch)
            got = ts.ShardSampler(n, shards, shard, shuffle=shuffle, seed=3,
                                  extend=extend).epoch_indices(epoch)
            np.testing.assert_array_equal(got, want)


def test_shard_sampler_extend_covers_and_interleaves():
    n, P = 103, 4
    shards = [ts.ShardSampler(n, P, s, shuffle=False,
                              extend=True).epoch_indices(0) for s in range(P)]
    assert len({len(s) for s in shards}) == 1
    re = np.swapaxes(np.stack(shards), 0, 1).reshape(-1)[:n]
    np.testing.assert_array_equal(re, np.arange(n))


@pytest.mark.parametrize("block", [None, 1, 2, 4])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_infinite_sampler_matches_jax(block, shards):
    n = 10                     # n % batch != 0: epochs straddle batches
    for shard in range(shards):
        want = list(itertools.islice(iter(js.InfiniteSampler(
            n, shards, shard, seed=3, block=block)), 40))
        got = list(itertools.islice(iter(ts.InfiniteSampler(
            n, shards, shard, seed=3, block=block)), 40))
        assert got == want


class _Null:
    supports_rng = True

    def __len__(self):
        return 10

    def __getitem__(self, i, rng=None):
        return np.zeros(1, np.float32)


@pytest.mark.parametrize("skip_steps", [0, 3])
@pytest.mark.parametrize("rounds", [1, 2])
def test_block_sharded_stream_is_the_single_process_stream(skip_steps,
                                                           rounds):
    """P ranks loading blocks of local_batch / rounds items (the port's
    training loop) yield, round by round, the rows of the single-process
    stream in order, and the loader puts each item at its single-process
    position; the JAX package's loader gives the same positions."""
    n, B, P = 10, 8, 2
    lb = B // P
    b = lb // rounds
    sp = list(itertools.islice(iter(ts.InfiniteSampler(n, seed=3)),
                               (skip_steps + 5) * B))[skip_steps * B:]
    shards = []
    for p in range(P):
        it = iter(ts.InfiniteSampler(n, P, p, seed=3, block=b))
        if skip_steps:
            next(itertools.islice(it, skip_steps * lb - 1,
                                  skip_steps * lb))
        shards.append(list(itertools.islice(it, 5 * lb)))
    got = []
    for step in range(5):
        for r in range(rounds):
            for p in range(P):
                lo = step * lb + r * b
                got.extend(shards[p][lo:lo + b])
    assert got == sp

    sp_pos = [skip_steps * B + t for t in range(2 * B)]
    for mod in (ts, js):
        pos = []
        for step in range(2):
            for r in range(rounds):
                for p in range(P):
                    dl = mod.DataLoader(_Null(), lb, seed=0,
                                        start_position=skip_steps * B + p * b,
                                        position_stride=P, position_block=b)
                    pos.extend(dl._position(step * lb + r * b + j)
                               for j in range(b))
        assert pos == sp_pos, (mod.__name__, pos)


def test_loader_items_take_their_positions_rngs():
    """Each item is made with the RandomState of its global position: two
    ranks' loaders, re-interleaved, give the single-process loader's
    per-item draws."""
    class Draw(_Null):
        def __getitem__(self, i, rng=None):
            return np.float64(rng.rand())

    one = np.concatenate([b for b in ts.DataLoader(
        Draw(), 4, indices=range(8), num_workers=2, seed=5)])
    parts = [np.concatenate([b for b in ts.DataLoader(
        Draw(), 2, indices=range(4), num_workers=2, seed=5,
        start_position=2 * p, position_stride=2, position_block=2)])
        for p in range(2)]
    two = np.concatenate([parts[p][k:k + 2] for k in (0, 2)
                          for p in range(2)])
    np.testing.assert_array_equal(two, one)


LAUNCHER_ENV = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT="29500")


def test_initialize_without_the_launcher_env_starts_nothing(monkeypatch):
    import torch

    from migan_tpu_torch import parallel

    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert parallel.maybe_initialize_distributed("cpu") == torch.device(
        "cpu")
    assert not parallel.is_initialized()
    assert parallel.world() == 1 and parallel.rank() == 0
    x = torch.arange(4.0)
    assert parallel.all_gather_rows(x) is x
    assert parallel.all_reduce_mean([x])[0] is x
    assert parallel.broadcast_scalar(None) is None
    assert "backend none, world 1, rank 0" in parallel.describe("cpu")


def test_initialize_refuses_what_it_cannot_honour(monkeypatch):
    """`cuda` without a card raises (no CPU group instead), and so does a
    partial launcher env; neither starts a group."""
    from migan_tpu_torch import parallel

    for k, v in LAUNCHER_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.maybe_initialize_distributed("cuda")
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="incomplete launcher env"):
        parallel.maybe_initialize_distributed("cpu")
    assert not parallel.is_initialized()
