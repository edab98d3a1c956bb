"""The port's per-host journal segments against the JAX reference's: the
merged view equals the single journal's, a crash on either side of the
merge's snapshot loses and duplicates nothing, the merge lock, switching
journal modes, and segments written by either package recovering
bitwise in the other, with the same merged records, watermarks and
snapshot bytes (small trees, on the CPU)."""
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from repro.checkpoint import journal as jax_journal
from repro.checkpoint.backends import LocalFSBackend as JaxLocal
from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.core import recovery as jax_rec
from repro_torch.checkpoint import journal
from repro_torch.checkpoint.backends import LocalFSBackend
from repro_torch.checkpoint.journal import (JournalSegment, ManifestJournal,
                                            SegmentedManifestJournal,
                                            list_segment_hosts,
                                            merge_segment_records,
                                            segment_path)
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core import recovery as rec
from repro_torch.maintenance import InjectedCrash, MaintenanceService


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the suite's parallel workers
    would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def pay(s):
    return {"g": np.full(64, float(s), np.float32)}


def full_state(s):
    return {"params": pay(s), "step": np.int32(s)}


def seg_tree_write(root, hosts=3, per_host=5, mod=journal):
    """Each host appends its own disjoint diff entries, host 0 a full."""
    journals = [mod.SegmentedManifestJournal(root, host=f"h{i}",
                                             compact_every=10_000)
                for i in range(hosts)]
    journals[0].append("add", "fulls",
                       entry={"step": 2, "key": "full_00000002", "bytes": 1})
    step = 3
    for _ in range(per_host):
        for j in journals:
            j.append("add", "diffs",
                     entry={"step": step, "key": f"diff_{step:08d}",
                            "bytes": 1, "host": j.host})
            step += 1
    return journals, step


def normalized(manifest):
    return {k: sorted(str(e) for e in v) for k, v in manifest.items() if v}


def test_segment_helpers(tmp_path):
    root = str(tmp_path)
    assert list_segment_hosts(root) == []
    seg = JournalSegment(root, "h1")
    assert not os.path.exists(seg.path)        # opened lazily
    seg.append_record({"seq": 1, "host": "h1", "op": "add",
                       "kind": "diffs", "entry": {"key": "diff_00000001",
                                                  "step": 1}})
    seg.close()
    with open(os.path.join(root, "manifest.log"), "w"):
        pass                                   # the single journal's log
    assert segment_path(root, "h1") == seg.path
    assert list_segment_hosts(root) == ["h1"]
    with pytest.raises(ValueError):
        JournalSegment(root, "../x")


def test_segmented_merge_matches_single_journal(tmp_path):
    single = ManifestJournal(str(tmp_path / "single"), compact_every=10_000)
    sjournals, step = seg_tree_write(str(tmp_path / "seg"))
    single.append("add", "fulls",
                  entry={"step": 2, "key": "full_00000002", "bytes": 1})
    for s in range(3, step):
        single.append("add", "diffs",
                      entry={"step": s, "key": f"diff_{s:08d}", "bytes": 1,
                             "host": f"h{(s - 3) % 3}"})
    for j in sjournals:
        j.close()
    reader = SegmentedManifestJournal(str(tmp_path / "seg"), host="reader")
    assert normalized(reader.manifest) == normalized(single.manifest)
    reader.compact()
    reader.close()
    reader2 = SegmentedManifestJournal(str(tmp_path / "seg"), host="r2")
    assert normalized(reader2.manifest) == normalized(single.manifest)
    reader2.close()
    single.close()


def test_segmented_store_recovery_bit_identical_to_single(tmp_path):
    one = CheckpointStore(str(tmp_path / "one"))
    mroot = str(tmp_path / "many")
    h0 = CheckpointStore(backend=LocalFSBackend(mroot), host_id="h0")
    h1 = CheckpointStore(backend=LocalFSBackend(mroot), host_id="h1")
    one.save_full(2, full_state(2))
    h0.save_full(2, full_state(2))
    for s in range(3, 9):
        one.save_diff(s, pay(s))
        (h0 if s % 2 else h1).save_diff(s, pay(s))
    h0.close()
    h1.close()
    reader = CheckpointStore(backend=LocalFSBackend(mroot), host_id="rd")
    sa, da = rec.load_latest_chain(one)
    sb, db = rec.load_latest_chain(reader)
    assert int(sa["step"]) == int(sb["step"]) == 2
    np.testing.assert_array_equal(sa["params"]["g"], sb["params"]["g"])
    assert [s for s, _ in da] == [s for s, _ in db] == list(range(3, 9))
    for (_, a), (_, b) in zip(da, db):
        np.testing.assert_array_equal(a["g"], b["g"])
    assert not os.path.exists(segment_path(mroot, "rd"))
    reader.close()
    one.close()


@pytest.mark.parametrize("point", ["merge:premerge", "merge:snapshotted"])
def test_merge_crash_is_idempotent(tmp_path, point):
    root = str(tmp_path / "mc")
    journals, _ = seg_tree_write(root, hosts=2, per_host=4)
    before = normalized(SegmentedManifestJournal(root, host="peek").manifest)
    merger = journals[0]

    def boom(p):
        if p == point:
            raise InjectedCrash(p)
    merger._crash_hook = boom
    with pytest.raises(InjectedCrash):
        merger.compact()
    merger._crash_hook = None
    for j in journals:
        j.close()
    after = SegmentedManifestJournal(root, host="after")
    assert normalized(after.manifest) == before
    after.compact()
    after.close()
    final = SegmentedManifestJournal(root, host="final")
    assert normalized(final.manifest) == before
    final.close()


def test_service_merge_task_with_segmented_store(tmp_path):
    root = str(tmp_path / "svcmerge")
    store = CheckpointStore(backend=LocalFSBackend(root), host_id="h0")
    for step in (4, 8):
        for d in range(step - 3, step):
            store.save_diff(d, pay(d))
        store.save_full(step, full_state(step))
    svc = MaintenanceService(store)
    store.attach_maintenance(svc)
    svc.start()
    svc.request_merge()
    store.flush(timeout=30.0)
    assert svc.merge_runs == 1
    assert store.journal.log_bytes() == 0
    reader = CheckpointStore(backend=LocalFSBackend(root), host_id="r")
    assert [e["step"] for e in reader.manifest["fulls"]] == [4, 8]
    reader.close()
    store.close()


def test_journal_mode_switch_loses_no_records(tmp_path):
    root = str(tmp_path / "modes")
    plain = CheckpointStore(root)
    plain.save_full(4, full_state(4))
    plain.save_diff(5, pay(5))
    plain.close()
    seg = CheckpointStore(backend=LocalFSBackend(root), host_id="h0")
    assert [e["step"] for e in seg.manifest["fulls"]] == [4]
    seg.save_diff(6, pay(6))
    seg.close()
    back = CheckpointStore(root)
    assert sorted(e["step"] for e in back.manifest["diffs"]) == [5, 6]
    back.save_diff(7, pay(7))
    back.journal.compact()
    back.close()
    final = CheckpointStore(root)
    assert sorted(e["step"] for e in final.manifest["diffs"]) == [5, 6, 7]
    assert [e["step"] for e in final.manifest["fulls"]] == [4]
    final.close()


def test_merge_lock_serializes_cross_host_compaction(tmp_path):
    root = str(tmp_path / "lock")
    journals, _ = seg_tree_write(root, hosts=2, per_host=3)
    lock = os.path.join(root, SegmentedManifestJournal.MERGE_LOCK)
    with open(lock, "w"):
        pass
    assert journals[1].compact() is False
    assert journals[1].merge_contentions == 1
    os.utime(lock, (time.time() - 600, time.time() - 600))
    assert journals[0].compact() is True
    for j in journals:
        j.close()
    reader = SegmentedManifestJournal(root, host="r")
    assert len(reader.manifest["diffs"]) == 6
    reader.close()


def test_own_torn_tail_is_truncated_others_are_not(tmp_path):
    root = str(tmp_path / "torn")
    journals, _ = seg_tree_write(root, hosts=2, per_host=2)
    for j in journals:
        j.close()
    for h in ("h0", "h1"):
        with open(segment_path(root, h), "a", encoding="utf-8") as f:
            f.write('{"seq": 99, "op": "ad')
    sizes = {h: os.path.getsize(segment_path(root, h)) for h in ("h0", "h1")}
    j0 = SegmentedManifestJournal(root, host="h0")
    assert len(j0.manifest["diffs"]) == 4
    assert os.path.getsize(segment_path(root, "h0")) < sizes["h0"]
    assert os.path.getsize(segment_path(root, "h1")) == sizes["h1"]
    j0.append("add", "diffs", entry={"step": 50, "key": "diff_00000050"})
    j0.close()
    assert len(SegmentedManifestJournal(root, host="x").manifest["diffs"]) \
        == 5


# ----------------------------------------------------------------------
# across the packages
# ----------------------------------------------------------------------

STORES = {"port": (CheckpointStore, LocalFSBackend, rec),
          "ref": (JaxStore, JaxLocal, jax_rec)}


def _write_two_hosts(root, pkg):
    Store, Local, _ = STORES[pkg]
    h0 = Store(backend=Local(root), host_id="h0")
    h1 = Store(backend=Local(root), host_id="h1")
    h0.save_full(2, full_state(2))
    for s in range(3, 7):
        (h0 if s % 2 else h1).save_diff(s, pay(s))
    h1.journal.compact()                   # a merge halfway
    for s in range(7, 11):
        (h0 if s % 2 else h1).save_diff(s, pay(s))
    h1.save_full(10, full_state(10))
    h0.save_diff(11, pay(11))
    h0.close()
    h1.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_segments_recover_bitwise_in_the_other_package(tmp_path, writer):
    root = str(tmp_path / "segs")
    _write_two_hosts(root, writer)
    loaded = {}
    for pkg, (Store, Local, recmod) in STORES.items():
        store = Store(backend=Local(root), host_id=f"rd_{pkg}")
        loaded[pkg] = (recmod.load_latest_chain(store),
                       sorted(store._entry_key(e)
                              for k in ("fulls", "diffs")
                              for e in store.manifest[k]))
        store.close()
    (sa, da), keys_a = loaded["port"]
    (sb, db), keys_b = loaded["ref"]
    assert keys_a == keys_b
    assert int(sa["step"]) == int(sb["step"]) == 10
    assert np.asarray(sa["params"]["g"]).tobytes() == \
        np.asarray(sb["params"]["g"]).tobytes()
    assert [s for s, _ in da] == [s for s, _ in db] == [11]
    assert np.asarray(da[0][1]["g"]).tobytes() == \
        np.asarray(db[0][1]["g"]).tobytes()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_merge_segment_records_is_the_same_in_both(tmp_path, writer):
    root = str(tmp_path / "m")
    journals, _ = seg_tree_write(
        root, hosts=3, per_host=3,
        mod=journal if writer == "port" else jax_journal)
    journals[1].compact()
    journals[2].append("del", "diffs", key="diff_00000004")
    journals[0].append("replace", "fulls", key="full_00000002",
                       entry={"step": 2, "key": "full_00000002",
                              "bytes": 1, "state_step": 3})
    for j in journals:
        j.close()
    for marks in ({}, {"h0": 1, "h2": 4}):
        assert merge_segment_records(root, marks) == \
            jax_journal.merge_segment_records(root, marks)
    assert list_segment_hosts(root) == jax_journal.list_segment_hosts(root)
    mine = SegmentedManifestJournal(root, host="rd")
    ref = jax_journal.SegmentedManifestJournal(root, host="rd2")
    assert mine.manifest == ref.manifest
    assert mine._watermarks == ref._watermarks
    mine.close()
    ref.close()


def test_merged_snapshot_is_byte_identical(tmp_path):
    """The same segments merged by either package give the same
    ``manifest.json`` bytes, and each reads the other's snapshot."""
    src = str(tmp_path / "src")
    journals, _ = seg_tree_write(src, hosts=2, per_host=3)
    for j in journals:
        j.close()
    snaps = {}
    for pkg, mod in (("port", journal), ("ref", jax_journal)):
        root = str(tmp_path / pkg)
        shutil.copytree(src, root)
        j = mod.SegmentedManifestJournal(root, host="h0")
        assert j.compact() is True
        j.close()
        with open(os.path.join(root, "manifest.json"), "rb") as f:
            snaps[pkg] = f.read()
    assert snaps["port"] == snaps["ref"]
    assert json.loads(snaps["port"])["__segseq__"] == {"h0": 4, "h1": 3}
    for reader, writer in ((journal, "ref"), (jax_journal, "port")):
        j = reader.SegmentedManifestJournal(str(tmp_path / writer), host="x")
        assert len(j.manifest["diffs"]) == 6
        j.close()
