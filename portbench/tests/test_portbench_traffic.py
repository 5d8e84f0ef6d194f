"""The traffic generator: the same seed gives the same pool, audio and
batches; another seed the same lengths in another order with other audio."""
import itertools

import numpy as np

from portbench.harness.traffic import Pool


def _take(pool, n):
    return list(itertools.islice(pool.passes(), n))


def test_same_seed_same_traffic(tiny_mix):
    a, b = Pool(tiny_mix, 2 ** 33 + 1, "cpu", hop=10), Pool(tiny_mix, 2 ** 33 + 1, "cpu", hop=10)
    assert np.array_equal(a.lengths, b.lengths)
    assert all(np.array_equal(a.pcm(i), b.pcm(i)) for i in range(len(a.lengths)))
    assert _take(a, 12) == _take(b, 12)


def test_other_seed_other_order_same_sizes(tiny_mix):
    a, b = Pool(tiny_mix, 1, "cpu", hop=10), Pool(tiny_mix, 2, "cpu", hop=10)
    assert np.array_equal(a.lengths, b.lengths)
    assert not np.array_equal(a.pcm(0), b.pcm(0))
    assert _take(a, 12) != _take(b, 12)


def test_pool_shape(tiny_mix):
    pool = Pool(tiny_mix, 5, "cpu", hop=10)
    assert len(pool.lengths) == 4 * tiny_mix["batch_size"]
    assert np.all(pool.lengths % 10 == 0)
    assert np.all(pool.lengths <= pool.bucket)
    assert np.all(pool.lengths > pool.bucket - 160)
    for batch in _take(pool, 8):  # one bucket a batch, full batches
        assert len(batch) == tiny_mix["batch_size"]
        assert len({int(pool.bucket[u]) for u in batch}) == 1
    first_pass = sorted(u for b in _take(pool, 4) for u in b)
    assert first_pass == list(range(len(pool.lengths)))
    assert pool.pcm(0).dtype == np.int16 and len(pool.pcm(0)) == pool.lengths[0]


def test_mix_file_lengths():
    """The mix's pool: mean about 12.7-13 s, three quarters 10-17 s, at most 35 s."""
    from portbench.harness.bench import BENCH, load_json

    mix = load_json(BENCH / "traffic" / "extract-ls.json")
    n = {float(k): v * mix["batch_size"] for k, v in mix["buckets"].items()}
    total = sum(n.values())
    mean = sum((k - 0.5) * v for k, v in n.items()) / total
    assert 12.5 < mean < 13.2
    assert 0.7 <= sum(v for k, v in n.items() if 10 < k <= 17) / total <= 0.8
    assert max(n) == 35
