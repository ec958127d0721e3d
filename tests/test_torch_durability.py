"""The port's write-ahead log, snapshot generations and recovery.

The reference's durability cases (``tests/test_durability.py``) run on
the port with ``device="cpu"``: WAL frame round trips, segment rotation,
torn headers and payloads, CRC mismatches, implausible lengths, bad
magic, the read-only scan, the injected torn-write / bit-flip / fsync
faults, ``atomic_write_bytes`` / ``atomic_rename_dir``, and the
``DurabilityManager`` end to end (WAL-only replay, torn tails, idempotent
deletes and ``clear``, snapshots with pruning, a corrupt generation, temp
debris, session records, the writer's fresh segment, stats, the group
policy).

Two cross-package checks, both exact: the same mutation sequence attached
to a manager under ``never`` writes byte-identical segment files in both
packages, and a data directory written by either package recovers in the
other to equal columns, dictionary and SELECT rows.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import pytest

from kolibrie_tpu_torch.durability import fsio, wal
from kolibrie_tpu_torch.durability.manager import DurabilityManager
from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase
from kolibrie_tpu_torch.resilience.errors import DurabilityError
from kolibrie_tpu_torch.resilience.faultinject import (
    FaultPlan,
    InjectedBitFlip,
    InjectedFsyncFault,
    InjectedTornWrite,
)
from test_torch_plan_cache import fresh_jax_compile_cache
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(autouse=True)
def _compile_cache_state():
    """``DurabilityManager.recover`` points the kernel build at
    ``<data_dir>/compile_cache``; give the process its setting back."""
    from kolibrie_tpu_torch.ops import kernels
    from kolibrie_tpu_torch.query import compile_cache

    saved = (compile_cache._active_dir, kernels._BUILD_DIR[0])
    yield
    compile_cache._active_dir, kernels._BUILD_DIR[0] = saved


# ------------------------------------------------------------------ helpers


def wal_dir(tmp_path):
    d = str(tmp_path / "wal")
    os.makedirs(d, exist_ok=True)
    return d


def triples(db):
    return sorted(db.iter_decoded())


def seed_db(n=20, prefix="e"):
    db = SparqlDatabase(device="cpu")
    for i in range(n):
        db.add_triple_parts(f"<http://x/{prefix}{i}>", "<http://x/p>", f"<http://x/v{i % 7}>")
    return db


def manager(data, **kw):
    return DurabilityManager(data, fsync_policy=kw.pop("fsync_policy", "always"),
                             device="cpu", **kw)


# ------------------------------------------------------- WAL frame encoding


def test_wal_record_round_trip(tmp_path):
    d = wal_dir(tmp_path)
    w = wal.WalWriter(d, fsync_policy="always")
    metas = [{"k": "mut", "st": "s", "i": i, "note": "π ≠ ascii"} for i in range(5)]
    tails = [bytes(range(i + 1)) * 3 for i in range(5)]
    for m, t in zip(metas, tails):
        w.append(m, t)
    w.close()
    records, stats = wal.scan_wal(d)
    assert [m for m, _ in records] == metas
    assert [t for _, t in records] == tails
    assert (stats.records, stats.corrupt_reason, stats.truncated_records) == (5, None, 0)
    empty, stats = wal.scan_wal(wal_dir(tmp_path / "empty"))
    assert empty == [] and stats.records == 0 and stats.corrupt_reason is None
    with pytest.raises(ValueError):
        wal.WalWriter(wal_dir(tmp_path), fsync_policy="sometimes")


def test_wal_segment_rotation(tmp_path):
    d = wal_dir(tmp_path)
    w = wal.WalWriter(d, fsync_policy="never", segment_bytes=64)  # every append rotates
    for i in range(4):
        w.append({"k": "mut", "i": i}, b"x" * 64)
    assert w.seal_if_dirty() is None  # the fresh segment holds nothing
    w.close()
    assert len(wal.list_segments(d)) >= 4
    records, stats = wal.scan_wal(d)
    assert [m["i"] for m, _ in records] == [0, 1, 2, 3] and stats.segments >= 4


@pytest.mark.parametrize("rotate", ["seal", "size"])
def test_wal_write_token_names_the_segment_holding_the_last_write(tmp_path, rotate):
    """A follower's poll sealing the active segment, or an append rotating
    it, between a write and its read-your-writes token leaves the active
    segment empty: the token names the sealed segment that holds the
    write, not the empty one, which no seal ships until the next write."""
    d = wal_dir(tmp_path)
    w = wal.WalWriter(d, fsync_policy="never", segment_bytes=64 if rotate == "size" else 1 << 20)
    assert w.write_token() == w.position() == (1, len(wal.SEG_MAGIC))  # nothing written
    w.append({"k": "mut", "i": 0}, b"x" * 64)
    if rotate == "seal":
        assert w.write_token() == w.position()
        assert w.seal_if_dirty() == 1
    assert w.position() == (2, len(wal.SEG_MAGIC))
    assert w.write_token() == (1, os.path.getsize(wal.segment_path(d, 1)))
    w.append({"k": "mut", "i": 1})
    assert w.write_token() == w.position() and w.position()[0] == 2
    w.close()


def _append_raw(d, segment, raw):
    with open(wal.segment_path(d, segment), "ab") as fh:
        fh.write(raw)


def _three_records(d, **kw):
    w = wal.WalWriter(d, fsync_policy="always", **kw)
    for i in range(3):
        w.append({"i": i})
    return w


TAILS = {
    # 1 byte of a frame header: torn at crash
    "torn_header": (lambda: b"\x07", "torn frame header", [0, 1, 2]),
    # a payload cut short
    "torn_payload": (lambda: wal.encode_record({"i": 3}, b"tail-bytes")[:-4],
                     "torn record payload", [0, 1, 2]),
    # a corrupt length field must not make the scanner allocate gigabytes
    "implausible_length": (lambda: struct.pack("<II", wal.MAX_RECORD_BYTES + 1, 0) + b"junk",
                           "implausible record length", [0, 1, 2]),
}


@pytest.mark.parametrize("case", sorted(TAILS))
def test_wal_bad_tail_is_truncated(tmp_path, case):
    raw, reason, want = TAILS[case]
    d = wal_dir(tmp_path)
    w = _three_records(d)
    seg = w.segment
    w.close()
    _append_raw(d, seg, raw())
    records, stats = wal.scan_wal(d)
    assert [m["i"] for m, _ in records] == want
    assert reason in stats.corrupt_reason and stats.truncated_records == 1
    records2, stats2 = wal.scan_wal(d)  # physically truncated: a re-scan is clean
    assert len(records2) == len(want) and stats2.corrupt_reason is None


def test_wal_crc_mismatch_truncates_and_drops_later_segments(tmp_path):
    d = wal_dir(tmp_path)
    w = _three_records(d, segment_bytes=1 << 20)
    first = w.segment
    w.rotate()
    w.append({"i": 3})
    later = w.segment
    w.close()
    path = wal.segment_path(d, first)
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0x01  # one payload bit of the first segment's last record
    with open(path, "wb") as fh:
        fh.write(blob)
    records, stats = wal.scan_wal(d)
    assert [m["i"] for m, _ in records] == [0, 1]
    assert "crc mismatch" in stats.corrupt_reason and stats.dropped_segments == 1
    assert not os.path.exists(wal.segment_path(d, later))


def test_wal_bad_magic_and_read_only_scan(tmp_path):
    d = wal_dir(tmp_path)
    with open(wal.segment_path(d, 1), "wb") as fh:
        fh.write(b"NOTMAGIC" + wal.encode_record({"i": 0}))
    records, stats = wal.scan_wal(d)
    assert records == [] and "bad segment magic" in stats.corrupt_reason
    d2 = wal_dir(tmp_path / "ro")
    w = wal.WalWriter(d2, fsync_policy="always")
    w.append({"i": 0})
    seg = w.segment
    w.close()
    _append_raw(d2, seg, b"\x01\x02")
    size = os.path.getsize(wal.segment_path(d2, seg))
    _records, stats = wal.scan_wal(d2, truncate=False)
    assert stats.corrupt_reason is not None
    assert os.path.getsize(wal.segment_path(d2, seg)) == size
    recs, _good, reason = wal.scan_segment_file(wal.segment_path(d2, seg))
    assert [m for m, _ in recs] == [{"i": 0}] and reason == "torn frame header"


# ----------------------------------------------------- injected disk faults


def test_fault_torn_write_fails_append_and_recovers_prefix(tmp_path):
    d = wal_dir(tmp_path)
    w = wal.WalWriter(d, fsync_policy="always")
    plan = FaultPlan(seed=1).add("wal.append", error=InjectedTornWrite, at_calls=[3])
    with plan.installed():
        w.append({"i": 0})
        w.append({"i": 1})
        with pytest.raises(DurabilityError, match="torn write"):
            w.append({"i": 2}, b"never-lands")
    w.close()
    records, stats = wal.scan_wal(d)
    assert [m["i"] for m, _ in records] == [0, 1]
    assert stats.corrupt_reason is not None and stats.truncated_bytes > 0


def test_fault_bit_flip_lands_silently_scan_catches_it(tmp_path):
    d = wal_dir(tmp_path)
    w = wal.WalWriter(d, fsync_policy="always")
    plan = FaultPlan(seed=1).add("wal.append", error=InjectedBitFlip, at_calls=[2])
    with plan.installed():
        w.append({"i": 0})
        w.append({"i": 1}, b"payload")  # corrupted on disk, no error raised
        w.append({"i": 2})
    w.close()
    records, stats = wal.scan_wal(d)
    assert [m["i"] for m, _ in records] == [0]
    assert "crc mismatch" in stats.corrupt_reason and stats.truncated_records == 1


def test_fault_fsync_failure_surfaces(tmp_path):
    d = wal_dir(tmp_path)
    w = wal.WalWriter(d, fsync_policy="always")
    plan = FaultPlan(seed=1).add("wal.fsync", error=InjectedFsyncFault, at_calls=[1])
    with plan.installed():
        with pytest.raises(InjectedFsyncFault):
            w.append({"i": 0})
        w.append({"i": 1})  # the disk recovered: the next append fsyncs fine
    w.close()
    records, _stats = wal.scan_wal(d)
    assert [m["i"] for m, _ in records] == [0, 1]


def test_group_policy_bounds_fsyncs(tmp_path, monkeypatch):
    d = wal_dir(tmp_path)
    w = wal.WalWriter(d, fsync_policy="group", group_interval_s=3600.0)
    real_fsync = os.fsync
    calls = []

    def counting_fsync(fd):
        calls.append(fd)
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", counting_fsync)
    for i in range(50):
        w.append({"i": i})
    assert calls == []  # no append-path fsync inside the hour-long interval
    w.flush()
    assert len(calls) == 1
    w.close()
    assert w._flusher is None  # the flusher thread is joined
    _records, stats = wal.scan_wal(d)
    assert stats.records == 50 and stats.corrupt_reason is None


# --------------------------------------------------------- fsio primitives


def test_atomic_write_bytes_and_rename_dir(tmp_path):
    p = str(tmp_path / "manifest.json")
    fsio.atomic_write_bytes(p, b"old-complete")
    with pytest.raises(RuntimeError):
        with fsio.atomic_write(p) as fh:
            fh.write(b"half-new")
            raise RuntimeError("crash mid-write")
    assert open(p, "rb").read() == b"old-complete"
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []
    fsio.atomic_write_bytes(p, b"new-complete")
    assert open(p, "rb").read() == b"new-complete"
    tmp, final = str(tmp_path / ".tmp-gen-1"), str(tmp_path / "gen-1")
    os.makedirs(tmp)
    fsio.atomic_write_bytes(os.path.join(tmp, "a.bin"), b"abc")
    fsio.atomic_rename_dir(tmp, final)
    assert not os.path.exists(tmp)
    assert open(os.path.join(final, "a.bin"), "rb").read() == b"abc"


# ------------------------------------------------------------------ manager


def test_manager_needs_a_device_or_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: no device means the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        DurabilityManager(str(tmp_path / "data"))


def test_manager_wal_replay_round_trip(tmp_path):
    data = str(tmp_path / "data")
    m = manager(data)
    m.start()
    db = SparqlDatabase(device="cpu")
    m.attach("store-1", db)
    for i in range(10):
        db.add_triple_parts(f"<http://x/s{i}>", "<http://x/p>", f'"{i}"')
    db.delete_triple(db.add_triple_parts("<http://x/s0>", "<http://x/p>", '"0"'))
    oracle = triples(db)
    m.close()
    assert db.store.journal is None  # close detaches
    m2 = manager(data)
    res = m2.recover()
    assert set(res.stores) == {"store-1"}
    got = res.stores["store-1"]
    assert triples(got) == oracle and got.device.type == "cpu"
    assert got.execution_mode == "auto" and got.store.journal is None
    st = res.stats
    assert st["replayed_records"] > 0 and st["truncated_records"] == 0
    assert st["snapshot_generation"] == 0
    m2.close()


def test_manager_recover_truncates_torn_tail_to_oracle(tmp_path):
    data = str(tmp_path / "data")
    m = manager(data)
    m.start()
    db = SparqlDatabase(device="cpu")
    m.attach("store-1", db)
    oracle_db = SparqlDatabase(device="cpu")
    plan = FaultPlan(seed=3).add("wal.append", error=InjectedTornWrite, at_calls=[8])
    applied = 0
    with plan.installed():
        for i in range(12):
            try:
                db.add_triple_parts(f"<http://x/s{i}>", "<http://x/p>", f'"{i}"')
            except DurabilityError:
                break
            oracle_db.add_triple_parts(f"<http://x/s{i}>", "<http://x/p>", f'"{i}"')
            applied += 1
    assert 0 < applied < 12
    m.close()
    m2 = manager(data)
    res = m2.recover()
    assert triples(res.stores["store-1"]) == triples(oracle_db)  # every acknowledged insert
    assert res.stats["corrupt_reason"] is not None and res.stats["truncated_records"] >= 1
    m2.close()


def test_manager_replay_is_idempotent_for_deletes_and_clear(tmp_path):
    data = str(tmp_path / "data")
    m = manager(data)
    m.start()
    db = SparqlDatabase(device="cpu")
    m.attach("store-1", db)
    t = db.add_triple_parts("<http://x/a>", "<http://x/p>", "<http://x/b>")
    db.add_triple_parts("<http://x/c>", "<http://x/p>", "<http://x/d>")
    db.delete_triple(t)
    db.store.clear()
    db.add_triple_parts("<http://x/e>", "<http://x/p>", "<http://x/f>")
    oracle = triples(db)
    m.close()
    m2 = manager(data)
    res = m2.recover()
    assert triples(res.stores["store-1"]) == oracle == [("http://x/e", "http://x/p", "http://x/f")]
    m2.close()


def test_manager_snapshot_prunes_and_recovers(tmp_path):
    data = str(tmp_path / "data")
    m = manager(data)
    m.start()
    db = seed_db(30)
    m.attach("store-1", db, log_create=True)
    g1 = m.snapshot({"store-1": db})
    assert g1 == 1
    db.add_triple_parts("<http://x/n1>", "<http://x/p>", '"1"')
    g2 = m.snapshot({"store-1": db})
    db.add_triple_parts("<http://x/post>", "<http://x/p>", '"after"')  # WAL only
    oracle = triples(db)
    assert not m.should_snapshot()
    m.close()
    gens = [n for n in os.listdir(os.path.join(data, "snapshots")) if n.startswith("gen-")]
    assert gens == [f"gen-{g2:08d}"]
    manifest = json.load(open(os.path.join(data, "snapshots", gens[0], "manifest.json")))
    assert min(wal.list_segments(os.path.join(data, "wal")),
               default=manifest["wal_start"]) >= manifest["wal_start"]
    assert manifest["stores"][0]["triples"] == 31
    m2 = manager(data)
    res = m2.recover()
    assert res.stats["snapshot_generation"] == 2 and res.stats["replayed_records"] == 1
    assert triples(res.stores["store-1"]) == oracle
    m2.close()


def test_manager_falls_back_past_corrupt_generation(tmp_path):
    data = str(tmp_path / "data")
    m = manager(data)
    m.start()
    db = seed_db(8)
    m.attach("store-1", db)
    m.snapshot({"store-1": db})
    m.close()
    store_file = os.path.join(data, "snapshots", "gen-00000001", "store-0.npz")
    blob = bytearray(open(store_file, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(store_file, "wb") as fh:
        fh.write(blob)
    debris = os.path.join(data, "snapshots", ".tmp-gen-00000009")
    os.makedirs(debris)
    m2 = manager(data)
    res = m2.recover()
    assert 1 in res.stats["invalid_generations"] and res.stats["gen_1_error"]
    assert res.stats["snapshot_generation"] == 0
    assert not os.path.exists(debris)  # a crash mid-snapshot leaves removable debris
    m2.close()


def test_manager_sessions_round_trip(tmp_path):
    data = str(tmp_path / "data")
    m = manager(data)
    m.start()
    seg0 = m.wal.segment
    cfg = {"query": "REGISTER ...", "window_size": 10}
    m.log_session_register("7", cfg)
    m.log_session_checkpoint("7", b'{"engine":"state-1"}')
    m.log_session_checkpoint("7", b'{"engine":"state-2"}')
    m.log_session_register("8", {"query": "other"})
    m.log_session_close("8")
    m.close()
    m2 = manager(data)
    res = m2.recover()
    assert set(res.sessions) == {"7"}
    assert res.sessions["7"] == {"register": cfg, "state": b'{"engine":"state-2"}'}
    assert m2.wal.segment > seg0  # the writer resumes on a fresh segment
    m2.snapshot({}, sessions={"3": {"register": {"query": "q"}, "state": b"blob3"}})
    m2.close()
    m3 = manager(data)
    res = m3.recover()
    assert res.sessions["3"] == {"register": {"query": "q"}, "state": b"blob3"}
    st = m3.stats()
    assert (st["fsync_policy"], st["wal"]["appended_records"]) == ("always", 0)
    assert st["last_recovery"]["snapshot_generation"] == 1 and st["generation"] == 1
    m3.close()


def test_kolibrie_fsync_env_sets_the_default_policy(tmp_path, monkeypatch):
    monkeypatch.setenv("KOLIBRIE_FSYNC", "never")
    m = DurabilityManager(str(tmp_path / "data"), device="cpu")
    m.start()
    assert m.fsync_policy == m.wal.fsync_policy == "never"
    m.close()


# ------------------------------------------------------------ cross-package

PFX = "PREFIX ex: <http://x/> "
STATEMENTS = [
    ("load", "".join(f'<http://x/s{i}> <http://x/p> "{i % 13}" .\n' for i in range(300))),
    ("sparql", PFX + 'INSERT DATA { ex:a ex:q ex:b . ex:b ex:q "ü" . ex:c ex:q ex:a }'),
    ("sparql", PFX + 'DELETE DATA { ex:s5 ex:p "5" . ex:a ex:q ex:b }'),
    ("load", "".join(f"<http://x/t{i}> <http://x/q> <http://x/s{i}> .\n" for i in range(200))),
    ("sparql", PFX + "DELETE { ?x ex:q ?y } WHERE { ?x ex:q ?y . ?y ex:p \"3\" }"),
    ("clear", None),
    ("load", "".join(f"<http://x/u{i}> <http://x/p> <http://x/u{i + 1}> .\n" for i in range(50))),
    ("sparql", PFX + "INSERT DATA { ex:u1 ex:q ex:u3 }"),
]
SELECT = PFX + "SELECT ?a ?c WHERE { ?a ex:p ?b . ?b ex:p ?c }"


def packages():
    from kolibrie_tpu.durability.manager import DurabilityManager as RefManager
    from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
    from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
    from kolibrie_tpu_torch.query.executor import execute_query_volcano

    return {
        "ref": (RefManager, RefDatabase, ref_execute, {}),
        "port": (DurabilityManager, SparqlDatabase, execute_query_volcano, {"device": "cpu"}),
    }


def apply(db, execute, statements):
    for kind, arg in statements:
        if kind == "load":
            db.parse_ntriples(arg)
        elif kind == "clear":
            db.store.clear()
        else:
            execute(arg, db)


def write_dir(pkg, data, snapshot_after=None):
    """Run STATEMENTS through ``pkg`` attached to a manager at ``data``
    (a snapshot after statement ``snapshot_after``); returns the db."""
    Manager, Database, execute, kw = packages()[pkg]
    m = Manager(data, fsync_policy="never", **kw)
    m.start()
    db = Database(**kw)
    m.attach("s", db)
    for i, st in enumerate(STATEMENTS):
        apply(db, execute, [st])
        if snapshot_after == i:
            m.snapshot({"s": db})
    db.store.compact()
    m.close()
    return db


def test_both_packages_write_the_same_wal_bytes(tmp_path):
    for pkg in ("ref", "port"):
        write_dir(pkg, str(tmp_path / pkg))
    segs = {pkg: wal.list_segments(str(tmp_path / pkg / "wal")) for pkg in ("ref", "port")}
    assert segs["port"] == segs["ref"] == [1]
    blobs = {pkg: open(wal.segment_path(str(tmp_path / pkg / "wal"), 1), "rb").read()
             for pkg in ("ref", "port")}
    assert blobs["port"] == blobs["ref"]
    records, stats = wal.scan_wal(str(tmp_path / "port" / "wal"), truncate=False)
    kinds = [(m["k"], m.get("ev")) for m, _ in records]
    assert ("mut", "clear") in kinds and ("mut", "del") in kinds and len(blobs["port"]) > 4000


def state(db):
    s, p, o = db.store.columns()
    return s.tolist(), p.tolist(), o.tolist(), list(db.dictionary.id_to_str)


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("snapshot_after", [None, 3], ids=["wal_only", "snapshot_and_tail"])
def test_recovery_crosses_packages(tmp_path, writer, snapshot_after):
    data = str(tmp_path / "data")
    pk = packages()
    reader = "port" if writer == "ref" else "ref"
    with fresh_jax_compile_cache(tmp_path / "jax_cache"):
        src = write_dir(writer, data, snapshot_after)
        Manager, _Database, execute, kw = pk[reader]
        m = Manager(data, fsync_policy="never", **kw)
        res = m.recover()
        got = res.stores["s"]
        want_rows = sorted(pk[writer][2](SELECT, src))
        got_rows = sorted(execute(SELECT, got))
        m.close()
    assert state(got) == state(src)
    assert got_rows == want_rows and len(got_rows) == 49
    assert res.stats["truncated_records"] == 0
    assert res.stats["snapshot_generation"] == (0 if snapshot_after is None else 1)
    if reader == "port":
        assert got.device.type == "cpu"
    assert isinstance(np.asarray(got.store.columns()[0]), np.ndarray)
