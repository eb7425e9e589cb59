"""Port parity: the synthetic data pipeline (`repro_torch.data`) draws the
JAX package's batches bit for bit — same seed, step and host shard — and
keeps the properties ``tests/test_runtime.py`` holds the reference to."""
import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro_torch.data import DataConfig, SyntheticLM

CONFIGS = [dict(vocab=1000, seq_len=64, global_batch=8),
           dict(vocab=151_936, seq_len=256, global_batch=8),
           dict(vocab=300, seq_len=1100, global_batch=2, seed=7,
                doc_len_mean=128)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_batches_are_the_references_bit_for_bit(kw):
    port, ref = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    for step in (0, 1, 5, 123):
        a, b = port.batch(step), ref.batch(step)
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    for a, b, _ in zip(port.iterate(3), ref.iterate(3), range(3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_host_shards_are_the_references():
    kw = dict(vocab=1000, seq_len=32, global_batch=8)
    for host in range(4):
        a = SyntheticLM(DataConfig(**kw), host_id=host, n_hosts=4).batch(3)
        b = JSyntheticLM(JDataConfig(**kw), host_id=host, n_hosts=4).batch(3)
        assert a["tokens"].shape == (2, 32)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_deterministic_shifted_and_in_vocab():
    d = SyntheticLM(DataConfig(vocab=500, seq_len=128, global_batch=4))
    a, b, c = d.batch(5), d.batch(5), d.batch(6)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert (a["labels"][:, :-1] == a["tokens"][:, 1:]).mean() > 0.95
    assert a["tokens"].min() >= 1 and a["tokens"].max() < 500
    assert (a["tokens"][:, 0] == 1).all()
