"""The traffic is fixed by the seed: the same seed gives the same inputs
and weights, another seed other voices over the same lengths."""

import numpy as np
import pytest
import torch


def offline_inputs(spec, seed):
    kind = spec.kind()
    params, _, tgt, pool = kind.build(spec, seed, "cpu")
    order = kind.Order(len(pool), seed)
    return params, tgt, pool, [order(i) for i in range(3 * len(pool))], kind.check_sample(spec.traffic, order, seed)


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 3_000_000_001])
def test_offline_deterministic(tiny_spec, seed):
    spec = tiny_spec("offline-fp32-long")
    a, b = offline_inputs(spec, seed), offline_inputs(spec, seed)
    assert all(torch.equal(a[0]["dec"][k], b[0]["dec"][k]) for k in a[0]["dec"])
    assert torch.equal(a[1], b[1])
    assert all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))
    assert a[3:] == b[3:]
    c = offline_inputs(spec, seed + 1)
    assert [len(x) for x in a[2]] == [len(x) for x in c[2]]          # the same lengths
    assert not np.array_equal(a[2][0], c[2][0])                       # other voices
    assert sorted(a[3][:len(a[2])]) == list(range(len(a[2])))         # each pass is the pool


def test_offline_sample_holds_the_longest(tiny_spec):
    spec = tiny_spec("offline-fp32-long")
    _, _, pool, order, sample = offline_inputs(spec, 9)
    longest = int(np.argmax([len(x) for x in pool]))
    assert any(order[i] == longest for i in sample)
    assert len(sample) == spec.traffic["check_requests"]


@pytest.mark.parametrize("seed", [1, 2**33 + 7])
def test_stream_deterministic(tiny_spec, seed):
    spec = tiny_spec("stream-fp32-60ms")
    kind = spec.kind()
    a, b = kind.build(spec, seed, 1.0, "cpu"), kind.build(spec, seed, 1.0, "cpu")
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]) and np.array_equal(a[3], b[3])
    n = spec.traffic["prime_chunks"] + spec.traffic["warmup_hops"] + kind.hops_in(spec, 1.0)
    assert a[3].shape == (n * spec.traffic["stream"]["chunk"],)
    c = kind.build(spec, seed + 1, 1.0, "cpu")
    assert not np.array_equal(a[3], c[3])
