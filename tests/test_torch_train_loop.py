"""The port's training driver end to end on the CPU: the loss falls, every
checkpoint epoch commits through Cornus, a crash after host 0's vote leaves
the epoch to be force-aborted, a resume reproduces the uncrashed loss curve,
and a 4-host epoch restores into a 2-host fleet.  The tier-1 tests run the
smoke config at batch 2 x 16 tokens for 6 steps; the slow-marked twins of
tests/test_train_loop.py run at its sizes."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import latest_committed  # noqa: E402
from repro_torch.ckpt.commit import _txn  # noqa: E402
from repro_torch.core.state import Decision, Vote  # noqa: E402
from repro_torch.core.storage import FileStore  # noqa: E402
from repro_torch.launch.train import (MidCheckpointCrash, RunConfig,  # noqa: E402
                                      _hosts, main, train)


def tiny_run(tmp, **kw):
    d = dict(arch="llama3.2-1b", steps=6, batch=2, seq_len=16, ckpt_every=3,
             ckpt_dir=str(tmp), n_hosts=4, log_every=0, lr=1e-2, warmup=2,
             seed=7, device="cpu")
    d.update(kw)
    return RunConfig(**d)


def test_loss_falls_and_every_epoch_commits(tmp_path):
    res = train(tiny_run(tmp_path))
    assert res.steps_done == 6 and len(res.losses) == len(res.step_s) == 6
    assert res.losses[0] == pytest.approx(np.log(512), rel=0.1)
    assert res.losses[5] < res.losses[1]
    assert [o.epoch for o in res.ckpt_outcomes] == [3, 6]
    assert all(o.decision == Decision.COMMIT and o.forced_aborts == 0
               for o in res.ckpt_outcomes)
    assert latest_committed(FileStore(str(tmp_path)), _hosts(4)) == 6


def test_crash_restart_reproduces_the_golden_curve(tmp_path):
    golden = train(tiny_run(tmp_path / "golden", ckpt_every=7))
    assert not golden.ckpt_outcomes
    with pytest.raises(MidCheckpointCrash) as crash:
        train(tiny_run(tmp_path / "crash", die_mid_checkpoint_at=6))
    partial = crash.value.result
    assert partial.steps_done == 6 and [o.epoch for o in
                                        partial.ckpt_outcomes] == [3]
    np.testing.assert_allclose(partial.losses, golden.losses, rtol=1e-5)
    store = FileStore(str(tmp_path / "crash"))
    hosts = _hosts(4)
    # Only host 0 voted in epoch 6: it resolves to ABORT, 3 is the latest.
    assert store.read_state("host0", _txn(6)) == Vote.VOTE_YES
    assert store.read_state("host1", _txn(6)) is None
    assert latest_committed(store, hosts) == 3
    assert store.read_state("host1", _txn(6)) == Vote.ABORT
    resumed = train(tiny_run(tmp_path / "crash", resume=True))
    assert resumed.restored_from == 3 and resumed.steps_done == 6
    np.testing.assert_allclose(resumed.losses, golden.losses[3:], rtol=1e-5)
    # Epoch 6 was force-aborted: the resumed run's vote cannot commit it.
    assert [(o.epoch, o.decision) for o in resumed.ckpt_outcomes] == \
        [(6, Decision.ABORT)]
    assert latest_committed(store, hosts) == 3


def test_elastic_restart_onto_two_hosts(tmp_path):
    train(tiny_run(tmp_path, steps=3, n_hosts=4))
    res = train(tiny_run(tmp_path, n_hosts=2, resume=True))
    assert res.restored_from == 3 and res.steps_done == 6
    assert latest_committed(FileStore(str(tmp_path)), _hosts(2)) == 6


def test_async_checkpoints_commit(tmp_path):
    res = train(tiny_run(tmp_path, async_ckpt=True))
    # Each of the 4 hosts' checkpointers reports both epochs.
    assert sorted(o.epoch for o in res.ckpt_outcomes) == [3] * 4 + [6] * 4
    assert all(o.decision == Decision.COMMIT for o in res.ckpt_outcomes)


def test_trains_xlstm_and_jamba_smoke(tmp_path):
    for arch in ("xlstm-125m", "jamba-v0.1-52b"):
        res = train(tiny_run(tmp_path / arch, arch=arch, steps=2, batch=1,
                             seq_len=8, ckpt_every=2))
        assert res.steps_done == 2 and np.isfinite(res.losses).all()
        assert res.ckpt_outcomes[0].decision == Decision.COMMIT


def test_main_runs_on_the_cpu(tmp_path, capsys):
    res = main(["--device", "cpu", "--steps", "2", "--batch", "1",
                "--seq-len", "8", "--ckpt-every", "2", "--n-hosts", "2",
                "--ckpt-dir", str(tmp_path), "--remat", "full"])
    assert res.steps_done == 2
    assert "[train] done: 2 steps" in capsys.readouterr().out


def test_train_refuses_the_cpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(RunConfig(ckpt_dir=str(tmp_path), steps=1))


# ---------------------------------------------------------------------------
# Twins of tests/test_train_loop.py at its sizes (minutes of CPU each).
# ---------------------------------------------------------------------------
def base_run(tmp, **kw):
    d = dict(arch="llama3.2-1b", steps=24, batch=4, seq_len=64,
             ckpt_every=8, ckpt_dir=str(tmp), n_hosts=3, log_every=0,
             lr=3e-3, seed=7, device="cpu")
    d.update(kw)
    return RunConfig(**d)


@pytest.mark.slow
def test_loss_decreases_and_ckpts_commit(tmp_path):
    res = train(base_run(tmp_path, steps=32))
    assert res.steps_done == 32
    assert np.mean(res.losses[-8:]) < np.mean(res.losses[:8])
    assert len(res.ckpt_outcomes) == 4
    assert all(o.decision == Decision.COMMIT for o in res.ckpt_outcomes)
    assert latest_committed(FileStore(str(tmp_path)), _hosts(3)) == 32


@pytest.mark.slow
def test_crash_restart_is_exact(tmp_path):
    golden = train(base_run(tmp_path / "golden"))
    with pytest.raises(MidCheckpointCrash):
        train(base_run(tmp_path / "crash", die_mid_checkpoint_at=16))
    store = FileStore(str(tmp_path / "crash"))
    assert latest_committed(store, _hosts(3)) == 8
    resumed = train(base_run(tmp_path / "crash", resume=True))
    assert resumed.restored_from == 8
    np.testing.assert_allclose(resumed.losses, golden.losses[8:], rtol=1e-5)


@pytest.mark.slow
def test_elastic_restart_smaller_fleet(tmp_path):
    train(base_run(tmp_path, steps=8, ckpt_every=8, n_hosts=4))
    res = train(base_run(tmp_path, steps=16, ckpt_every=8, n_hosts=2,
                         resume=True))
    assert res.restored_from == 8 and res.steps_done == 16
    assert latest_committed(FileStore(str(tmp_path)), _hosts(2)) == 16


@pytest.mark.slow
def test_byte_corpus_training(tmp_path):
    src = os.path.abspath(__file__)
    res = train(base_run(tmp_path, data_source=f"bytes:{src}", steps=30,
                         ckpt_every=30))
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
