"""The port's copy of the data pipeline gives the JAX package's batches:
the same tokens for every (seed, host, step), from the synthetic zipf
stream and from a byte corpus, and the prefetcher hands them out in step
order from any start step."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402


def both(**kw):
    return (jpipe.make_pipeline(jpipe.DataConfig(**kw)),
            tpipe.make_pipeline(tpipe.DataConfig(**kw)))


@pytest.mark.parametrize("host,n_hosts", [(0, 1), (1, 4), (3, 4)])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_tokens_match(seed, host, n_hosts):
    j, t = both(batch=3, seq_len=17, vocab_size=512, seed=seed, host=host,
                n_hosts=n_hosts)
    for step in (0, 1, 5, 123):
        jb, tb = j.batch_at(step), t.batch_at(step)
        assert sorted(jb) == sorted(tb) == ["labels", "tokens"]
        for k in jb:
            assert tb[k].dtype == jb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k])


def test_synthetic_tokens_at_the_full_vocab():
    """llama3.2-1b's vocabulary (128,256), as the card's training run."""
    j, t = both(batch=1, seq_len=64, vocab_size=128_256, seed=0)
    np.testing.assert_array_equal(t.batch_at(3)["tokens"],
                                  j.batch_at(3)["tokens"])


@pytest.mark.parametrize("host", [0, 2])
def test_byte_corpus_matches(host):
    src = "bytes:" + tpipe.__file__
    j, t = both(batch=4, seq_len=32, vocab_size=256, seed=3, host=host,
                source=src)
    for step in (0, 2, 9):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(t.batch_at(step)[k],
                                          j.batch_at(step)[k])


def test_prefetcher_hands_out_steps_in_order():
    _, t = both(batch=2, seq_len=8, vocab_size=64)
    pf = tpipe.Prefetcher(t, start_step=5)
    try:
        for want in range(5, 9):
            step, b = pf.get()
            assert step == want
            np.testing.assert_array_equal(b["tokens"],
                                          t.batch_at(want)["tokens"])
    finally:
        pf.stop()


def test_unknown_source_is_refused():
    with pytest.raises(ValueError, match="unknown data source"):
        tpipe.make_pipeline(tpipe.DataConfig(source="parquet:x"))
