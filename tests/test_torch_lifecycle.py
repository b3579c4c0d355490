"""Twin of ``tests/test_lifecycle.py`` on the port's modules
(``repro_torch.core``): the same assertions and parametrisations.

Durable-state lifecycle: record framing, crash-consistency, quarantine.

Covers the CRC32 record format (torn tail vs. bit-rot classification, typed
`CorruptRecord` results), the `FileStore` crash-consistency fixes (a
zero-length / truncated state file reads as absent instead of raising, a
writer killed mid-`log`/`put_data` leaves no orphan temp files behind after
the startup sweep), per-volume quarantine counting, and the truncation
tombstone that keeps a late terminator from re-claiming a GC'd slot.

Beyond the reference's cases: the port's ``encode_record`` /
``decode_record`` give the reference's bytes and classifications on the
same inputs, and the port's ``FileStore`` and the reference's read each
other's framed and torn state files the same way.  The kill -9 writer runs
the port in a child that imports ``repro_torch.core`` only; the parent
signals that child's pid alone and bounds every wait.  These tests import
no torch: the port's commit core is standard library only.
"""
from __future__ import annotations

import os
import select
import shutil
import signal
import subprocess
import sys
import textwrap

import pytest

import repro.core.lifecycle as jlifecycle
import repro.core.storage as jstorage
from repro_torch.core import Vote
from repro_torch.core.lifecycle import (CorruptRecord, LifecycleConfig,
                                        RECORD_MAGIC, decode_record,
                                        encode_record)
from repro_torch.core.storage import FileStore, MemoryStore

# Seconds the parent waits for the child's READY line and for its exit.
CHILD_TIMEOUT_S = 60.0


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------
def test_frame_round_trip():
    blob = encode_record(Vote.VOTE_YES.value, "n2")
    assert blob.startswith(RECORD_MAGIC)
    assert decode_record(blob) == (Vote.VOTE_YES.value, "n2")


def test_torn_tail_classified_torn():
    blob = encode_record(Vote.COMMIT.value, "n0")
    for cut in (1, 3, len(blob) - len(RECORD_MAGIC) - 1):
        rec = decode_record(blob[:-cut], "p", "t")
        assert isinstance(rec, CorruptRecord)
        assert rec.torn, f"cut={cut} should classify as torn"


def test_bit_rot_classified_rot_not_torn():
    blob = bytearray(encode_record(Vote.COMMIT.value, "n0"))
    # Flip a body byte (past the header newline) — full length, bad CRC.
    body_start = blob.index(b"\n") + 1
    blob[body_start] ^= 0x40
    rec = decode_record(bytes(blob), "p", "t")
    assert isinstance(rec, CorruptRecord)
    assert not rec.torn
    assert not rec.is_decision()
    assert rec.value == "CORRUPT"


def test_empty_and_garbage_blobs_are_torn():
    for blob in (b"", b"crc1", b"crc1 zz zz\nxx", b"not a frame"):
        rec = decode_record(blob)
        assert isinstance(rec, CorruptRecord) and rec.torn


def test_lifecycle_config_coerce():
    assert LifecycleConfig.coerce(None) is None
    lc = LifecycleConfig.coerce(dict(gc=True, gc_interval_ms=10.0))
    assert lc.gc and lc.gc_interval_ms == 10.0 and lc.checksums
    assert LifecycleConfig.coerce(lc) is lc
    assert LifecycleConfig.coerce(lc.to_dict()).gc
    with pytest.raises(TypeError):
        LifecycleConfig.coerce(42)


def _decoded(rec):
    """A decode result with the package's class taken off."""
    if hasattr(rec, "torn"):
        return ("CorruptRecord", rec.partition, rec.txn, rec.torn,
                rec.detail, rec.value, rec.is_decision())
    return rec


def _framing_cases():
    """Blobs of every class: whole frames, every torn cut, a flip of each
    body byte, and the garbage of the reference's test."""
    blobs = [b"", b"crc1", b"crc1 zz zz\nxx", b"not a frame",
             RECORD_MAGIC + b"00000000 00000000\n"]
    for value, writer in (("VOTE-YES", "n2"), ("COMMIT", "n0"),
                          ("ABORT", "restore"), ("COMMIT", "")):
        blob = encode_record(value, writer)
        blobs.append(blob)
        blobs += [blob[:-cut] for cut in range(1, len(blob))]
        body = blob.index(b"\n") + 1
        for i in range(body, len(blob)):
            rot = bytearray(blob)
            rot[i] ^= 0x01 << (i % 8)
            blobs.append(bytes(rot))
    return blobs


def test_framing_matches_the_reference_byte_for_byte():
    """``encode_record`` writes the reference's bytes, and
    ``decode_record`` gives the reference's values and classes (torn or
    rot, with the same detail) on every blob of ``_framing_cases``."""
    for value, writer in (("VOTE-YES", "n2"), ("COMMIT", "n0"),
                          ("ABORT", "restore"), ("COMMIT", ""),
                          ("ABORT", "wörker")):
        assert encode_record(value, writer) \
            == jlifecycle.encode_record(value, writer)
    assert RECORD_MAGIC == jlifecycle.RECORD_MAGIC
    for blob in _framing_cases():
        for args in ((blob,), (blob, "p", "t")):
            assert _decoded(decode_record(*args)) \
                == _decoded(jlifecycle.decode_record(*args)), blob


def test_lifecycle_config_matches_the_reference():
    for given in (dict(gc=True, gc_interval_ms=10.0), dict(checksums=False),
                  dict(scrub=True, quarantine_threshold=7)):
        assert LifecycleConfig.coerce(given).to_dict() \
            == jlifecycle.LifecycleConfig.coerce(given).to_dict()
    assert LifecycleConfig().to_dict() \
        == jlifecycle.LifecycleConfig().to_dict()


# ---------------------------------------------------------------------------
# FileStore crash consistency
# ---------------------------------------------------------------------------
def test_zero_length_state_file_reads_absent(tmp_path):
    """Regression: a torn create used to raise IndexError from _read."""
    fs = FileStore(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "state", "p0"), exist_ok=True)
    open(os.path.join(str(tmp_path), "state", "p0", "t0"), "wb").close()
    assert fs.read_state("p0", "t0") is None
    assert fs.torn_records >= 1
    # The slot is claimable: LogOnce treats the torn create as absent.
    assert fs.log_once("p0", "t0", Vote.VOTE_YES, writer="p0") \
        == Vote.VOTE_YES


def test_truncated_framed_file_reads_absent(tmp_path):
    fs = FileStore(str(tmp_path),
                   lifecycle=LifecycleConfig(checksums=True))
    assert fs.log_once("p0", "t1", Vote.VOTE_YES, writer="p0") \
        == Vote.VOTE_YES
    path = os.path.join(str(tmp_path), "state", "p0", "t1")
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:-2])
    assert fs.read_state("p0", "t1") is None
    assert fs.torn_records >= 1


def test_bit_rot_reads_as_typed_corrupt_record(tmp_path):
    fs = FileStore(str(tmp_path),
                   lifecycle=LifecycleConfig(checksums=True))
    fs.log("p0", "t2", Vote.COMMIT, writer="p0")
    path = os.path.join(str(tmp_path), "state", "p0", "t2")
    blob = bytearray(open(path, "rb").read())
    blob[blob.index(b"\n") + 1] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(blob))
    rec = fs.read_state("p0", "t2")
    assert isinstance(rec, CorruptRecord) and not rec.torn
    assert fs.corrupt_records == 1
    assert fs.scrub() == [path]        # scrub reports the rotted path


def test_repeated_rot_trips_quarantine(tmp_path):
    fs = FileStore(str(tmp_path),
                   lifecycle=LifecycleConfig(checksums=True,
                                             quarantine_threshold=3))
    for i in range(3):
        fs.log("p0", f"q{i}", Vote.COMMIT, writer="p0")
        path = os.path.join(str(tmp_path), "state", "p0", f"q{i}")
        blob = bytearray(open(path, "rb").read())
        blob[blob.index(b"\n") + 1] ^= 0x01
        with open(path, "wb") as f:
            f.write(bytes(blob))
        fs.read_state("p0", f"q{i}")
    assert fs.corrupt_records == 3
    assert fs.quarantines == 1


def test_orphan_tmp_files_swept_on_startup(tmp_path):
    sdir = os.path.join(str(tmp_path), "state", "p0")
    ddir = os.path.join(str(tmp_path), "data", "p0")
    os.makedirs(sdir)
    os.makedirs(ddir)
    for d in (sdir, ddir):
        with open(os.path.join(d, "x.tmp.123.456"), "wb") as f:
            f.write(b"partial")
    fs = FileStore(str(tmp_path))
    assert fs.orphans_swept == 2
    assert not [p for p in os.listdir(sdir) if ".tmp." in p]
    assert not [p for p in os.listdir(ddir) if ".tmp." in p]


@pytest.mark.parametrize("damage", ["zero", "torn", "rot", "intact"])
def test_file_stores_read_damaged_state_files_alike(tmp_path, damage):
    """One framed state file, damaged one way, read by both packages'
    FileStores on the same root: the same value or class, the same torn /
    corrupt counts and the same scrub report."""
    root = str(tmp_path / "root")
    lc = dict(checksums=True, quarantine_threshold=3)
    FileStore(root, lifecycle=LifecycleConfig(**lc)).log(
        "p0", "t", Vote.COMMIT, writer="p0")
    path = os.path.join(root, "state", "p0", "t")
    blob = bytearray(open(path, "rb").read())
    if damage == "zero":
        blob = bytearray()
    elif damage == "torn":
        blob = blob[:-3]
    elif damage == "rot":
        blob[blob.index(b"\n") + 2] ^= 0x10
    with open(path, "wb") as f:
        f.write(bytes(blob))
    # Reads may drop a torn file, so each package reads its own copy.
    other = str(tmp_path / "copy")
    shutil.copytree(os.path.join(root, "state"),
                    os.path.join(other, "state"))
    seen = []
    for top, store in ((root, FileStore(
            root, lifecycle=LifecycleConfig(**lc))),
                       (other, jstorage.FileStore(
                           other, lifecycle=jlifecycle.LifecycleConfig(
                               **lc)))):
        got = store.read_state("p0", "t")
        scrubbed = [os.path.relpath(p, top) for p in store.scrub()]
        seen.append((_decoded(getattr(got, "name", got)), store.torn_records,
                     store.corrupt_records, store.quarantines, scrubbed,
                     sorted(os.listdir(os.path.join(top, "state", "p0")))))
    assert seen[0] == seen[1]


# The child imports repro_torch.core only (tests/test_torch_hygiene.py
# holds this), so it starts in well under a second and never loads torch.
_KILL_SCRIPT = textwrap.dedent("""\
    import os, sys, threading
    sys.path.insert(0, {src!r})
    from repro_torch.core import Vote
    from repro_torch.core.storage import FileStore

    root = {root!r}
    fs = FileStore(root)
    # Patch the atomic-replace fsync to signal readiness then hang, so the
    # parent can SIGKILL us with the temp file guaranteed on disk.
    real_fsync = os.fsync
    def hang(fd):
        real_fsync(fd)
        print("READY", flush=True)
        threading.Event().wait()
    os.fsync = hang
    if {mode!r} == "log":
        fs.log("p0", "victim", Vote.COMMIT, writer="p0")
    else:
        fs.put_data("p0", "shard", b"x" * 128)
""")


def _read_ready(proc, timeout_s: float) -> bytes:
    """The child's first line, or b"" if none comes within ``timeout_s``."""
    ready, _w, _x = select.select([proc.stdout], [], [], timeout_s)
    return proc.stdout.readline() if ready else b""


@pytest.mark.parametrize("mode", ["log", "put_data"])
def test_writer_killed_mid_write_leaves_no_orphans(tmp_path, mode):
    """Kill -9 a writer while its temp file exists; a fresh FileStore on
    the same root must sweep the orphan and read the volume cleanly."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    script = _KILL_SCRIPT.format(src=src, root=str(tmp_path), mode=mode)
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE)
    try:
        assert _read_ready(proc, CHILD_TIMEOUT_S).strip() == b"READY"
    finally:
        # Only this child's pid is signalled, whatever the check found.
        if proc.poll() is None:
            os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=CHILD_TIMEOUT_S)
        proc.stdout.close()
    assert proc.returncode == -signal.SIGKILL
    leftovers = []
    for dirpath, _dirs, files in os.walk(str(tmp_path)):
        leftovers += [f for f in files if ".tmp." in f]
    assert leftovers, "test rig failed to strand a temp file"
    fs = FileStore(str(tmp_path))
    assert fs.orphans_swept == len(leftovers)
    for dirpath, _dirs, files in os.walk(str(tmp_path)):
        assert not [f for f in files if ".tmp." in f]
    # The interrupted write never reached its final path: absent, claimable.
    assert fs.read_state("p0", "victim") is None


# ---------------------------------------------------------------------------
# Truncation tombstones (MemoryStore; the sim stores delegate to it)
# ---------------------------------------------------------------------------
def test_gc_tombstone_blocks_late_terminator():
    ms = MemoryStore(lifecycle=LifecycleConfig(checksums=True, gc=True))
    ms.log_once("p0", "t", Vote.VOTE_YES, writer="p0")
    ms.log("p0", "t", Vote.COMMIT, writer="p0")
    assert ms.gc_pass() == 1
    assert ms.gc_log[0].decision == Vote.COMMIT.value
    # The slot is gone from the state map but a late CAS must NOT claim it.
    assert ms.log_once("p0", "t", Vote.ABORT, writer="n9") == Vote.COMMIT
    assert ms.read_state("p0", "t") == Vote.COMMIT
    assert ms.is_truncated(("p0", "t"))


def test_gc_refuses_unsettled_prefix():
    ms = MemoryStore(lifecycle=LifecycleConfig(checksums=True, gc=True))
    ms.log_once("p0", "a", Vote.VOTE_YES, writer="p0")   # in doubt
    ms.log_once("p0", "b", Vote.COMMIT, writer="p0")     # settled
    assert ms.gc_pass() == 0       # 'a' blocks the prefix
    assert ms.watermark_lag() == 2
    ms.log("p0", "a", Vote.ABORT, writer="p0")
    assert ms.gc_pass() == 2
    assert ms.watermark_lag() == 0


def test_decision_never_flips_in_log():
    """A zombie re-issue must not make a slot serve both terminal values."""
    ms = MemoryStore()
    assert ms.log("p0", "t", Vote.COMMIT, writer="p0") == Vote.COMMIT
    assert ms.log("p0", "t", Vote.ABORT, writer="p0") == Vote.COMMIT
    assert ms.read_state("p0", "t") == Vote.COMMIT


def test_decision_never_flips_in_filestore_log(tmp_path):
    fs = FileStore(str(tmp_path))
    assert fs.log("p0", "t", Vote.ABORT, writer="p0") == Vote.ABORT
    assert fs.log("p0", "t", Vote.COMMIT, writer="p0") == Vote.ABORT
    assert fs.read_state("p0", "t") == Vote.ABORT
