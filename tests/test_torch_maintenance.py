"""The port's maintenance service against the JAX reference's: resumable
GC (a kill at every journaled boundary loses no live blob and leaks no
dead one), the integrity scrub and quarantine, ``flush()``'s deadline and
error contract, the sweep sparing a put in flight, the GC plan equal to
the reference's on the same manifest, a progress log that one package
leaves half done finished by the other, directories written with a host
id, retention and the service recovering bitwise in the other package,
and the CLI with the service on (small trees, on the CPU)."""
import ast
import logging
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint.config import StoreConfig as JaxStoreConfig
from repro.core import recovery as jax_rec
from repro.maintenance import InjectedCrash as JaxInjectedCrash
from repro.maintenance import MaintenanceService as JaxService
from repro_torch.checkpoint import io as cio
from repro_torch.checkpoint.backends import LocalFSBackend
from repro_torch.checkpoint.config import StoreConfig
from repro_torch.checkpoint.remote import (FakeObjectStore,
                                           RemoteObjectBackend,
                                           RetryExhaustedError)
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core import recovery as rec
from repro_torch.core.reusing_queue import CheckpointingError
from repro_torch.maintenance import InjectedCrash, MaintenanceService

PAY_N = 64


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
    return {"g": np.full(PAY_N, float(s), np.float32)}


def full_state(s):
    return {"params": pay(s), "step": np.int32(s)}


def make(root, retention=0, host_id=None):
    return StoreConfig(str(root), retention_fulls=retention,
                       host_id=host_id).build()


def make_ref(root, retention=0, host_id=None):
    return JaxStoreConfig(str(root), retention_fulls=retention,
                          host_id=host_id).build()


def build_chain(store, fulls=(4, 8, 12, 16)):
    """full@4..16 with three diffs before each: GC at retention 2 dooms
    2 fulls and 9 diffs."""
    for step in fulls:
        for d in range(step - 3, step):
            store.save_diff(d, pay(d))
        store.save_full(step, full_state(step))


def manifest_keys(store):
    return {store._entry_key(e)
            for kind in ("fulls", "diffs", "batches", "quarantined")
            for e in store.manifest.get(kind, [])}


def assert_no_leak_no_loss(store):
    """The backend holds exactly the blobs the manifest references."""
    refd = manifest_keys(store)
    on_disk = set(store.backend.keys())
    assert on_disk - refd == set(), f"leaked blobs: {on_disk - refd}"
    assert refd - on_disk == set(), f"lost blobs: {refd - on_disk}"


def kill_at(svc, point, crash=InjectedCrash):
    """The worker dies, journaling nothing further, the first time it
    reaches ``point``."""
    armed = [True]

    def hook(p):
        if p == point and armed[0]:
            armed[0] = False
            raise crash(p)
    svc.crash_hook = hook


def wait_dead(svc, timeout=10.0):
    t = svc._thread
    if t is not None:
        t.join(timeout)
    assert not svc.running, "worker survived the injected crash"


def restart(root, retention=2, gc_slice=2):
    """A process restart: a fresh store from disk and a fresh service
    that resumes journaled work on start()."""
    store = make(root, retention)
    svc = MaintenanceService(store, gc_slice=gc_slice)
    store.attach_maintenance(svc)
    svc.start()
    svc.drain(30.0)
    return store, svc


def corrupt_file_tail(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))


# ----------------------------------------------------------------------
# resumable GC
# ----------------------------------------------------------------------

def test_service_gc_matches_sync_gc(tmp_path):
    sync_store = make(tmp_path / "sync")
    build_chain(sync_store)
    sync_store.gc(retention_fulls=2)
    svc_store = make(tmp_path / "svc")
    build_chain(svc_store)
    svc = MaintenanceService(svc_store, gc_slice=3)
    svc_store.attach_maintenance(svc)
    svc.start()
    svc.request_gc(2)
    svc_store.flush(timeout=30.0)
    assert manifest_keys(svc_store) == manifest_keys(sync_store)
    assert sorted(svc_store.backend.keys()) == sorted(
        sync_store.backend.keys())
    assert_no_leak_no_loss(svc_store)
    assert svc_store.stats()["gc_deleted"] == sync_store.gc_deleted == 11
    svc_store.close()
    sync_store.close()


def test_request_gc_sync_fallback_without_service(tmp_path):
    store = make(tmp_path / "fb", retention=2)
    build_chain(store)
    assert [e["step"] for e in store.manifest["fulls"]] == [12, 16]
    assert_no_leak_no_loss(store)
    store.close()


@pytest.mark.parametrize("point", ["gc:marked", "gc:mid_delete",
                                   "gc:swept_slice", "gc:cursored"])
def test_gc_crash_then_resume_loses_nothing(tmp_path, point):
    root = tmp_path / "crash"
    store = make(root)
    build_chain(store)
    svc = MaintenanceService(store, gc_slice=2)
    store.attach_maintenance(svc)
    kill_at(svc, point)
    svc.start()
    svc.request_gc(2)
    wait_dead(svc)
    with pytest.raises(CheckpointingError):
        svc.drain(1.0)
    store.journal.close()

    store2, svc2 = restart(root)
    assert svc2.resumed >= 1
    assert_no_leak_no_loss(store2)
    assert [e["step"] for e in store2.manifest["fulls"]] == [12, 16]
    replay = store2.diffs_after(12)
    assert [s for s, _ in replay] == [13, 14, 15]
    for s, p in replay:
        np.testing.assert_array_equal(p["g"], pay(s)["g"])
    store2.close()


def test_gc_resume_in_process_restarted_service(tmp_path):
    store = make(tmp_path / "inproc")
    build_chain(store)
    svc = MaintenanceService(store, gc_slice=2)
    store.attach_maintenance(svc)
    kill_at(svc, "gc:swept_slice")
    svc.start()
    svc.request_gc(2)
    wait_dead(svc)
    svc2 = MaintenanceService(store, gc_slice=2)
    store.attach_maintenance(svc2)
    svc2.start()
    svc2.drain(30.0)
    assert svc2.resumed == 1
    assert_no_leak_no_loss(store)
    assert [e["step"] for e in store.manifest["fulls"]] == [12, 16]
    store.close()


def test_gc_apply_skips_keys_back_in_live_chain(tmp_path):
    store = make(tmp_path / "stale")
    build_chain(store, fulls=(4, 8))
    doomed = store.gc_plan(retention_fulls=1)
    assert ("fulls", "full_00000004") in doomed
    store.save_full(4, full_state(4))
    store.gc_apply(store.gc_plan(retention_fulls=1), retention_fulls=1)
    assert store.latest_full()["step"] == 8
    assert store.backend.exists("full_00000008")
    assert_no_leak_no_loss(store)
    store.close()


class GatedLocal(LocalFSBackend):
    """A local tier whose put of ``gate_key`` holds open until released."""

    def __init__(self, root):
        super().__init__(root)
        self.gate_key = None
        self.entered = threading.Event()
        self.release = threading.Event()

    def put(self, key, obj):
        if key == self.gate_key:
            self.entered.set()
            assert self.release.wait(30.0)
        return super().put(key, obj)


def test_gc_never_dooms_a_key_whose_put_runs(tmp_path):
    """A plan names a full that is being put again when the sweep runs:
    the sweep skips it, and the put lands."""
    be = GatedLocal(str(tmp_path / "g"))
    store = CheckpointStore(backend=be)
    build_chain(store, fulls=(4, 8, 12))
    doomed = store.gc_plan(1)
    assert ("fulls", "full_00000004") in doomed
    be.gate_key = "full_00000004"
    t = threading.Thread(target=store.save_full, args=(4, full_state(4)))
    t.start()
    try:
        assert be.entered.wait(30.0)
        removed = store.gc_apply(doomed, retention_fulls=1)
    finally:
        be.release.set()
        t.join(30.0)
    assert removed["fulls"] == 1          # full 8; full 4's put ran
    assert store.backend.exists("full_00000004")
    assert "full_00000004" in manifest_keys(store)
    assert not store.backend.exists("full_00000008")
    store.close()


# ----------------------------------------------------------------------
# integrity scrub
# ----------------------------------------------------------------------

def test_scrub_quarantines_corrupt_full_and_recovery_falls_back(tmp_path):
    root = tmp_path / "scrub"
    store = make(root)
    store.save_full(4, full_state(4))
    for s in (5, 6):
        store.save_diff(s, pay(s))
    store.save_full(6, full_state(6))
    store.save_diff(7, pay(7))
    corrupt_file_tail(os.path.join(root, "full_00000006.ckpt"))
    svc = MaintenanceService(store, scrub_slice=2)
    store.attach_maintenance(svc)
    svc.start()
    svc.request_scrub()
    store.flush(timeout=30.0)
    assert svc.corrupt_found == 1
    q = store.manifest["quarantined"]
    assert len(q) == 1 and q[0]["key"] == "full_00000006"
    assert q[0]["src_kind"] == "fulls" and "sha256" in q[0]["reason"]
    state, diffs = rec.load_latest_chain(store)
    assert int(state["step"]) == 4
    assert [s for s, _ in diffs] == [5, 6, 7]
    assert store.stats()["quarantined"] == 1
    store.close()


def test_scrub_quarantined_diff_cuts_chain_at_gap(tmp_path):
    root = tmp_path / "qdiff"
    store = make(root)
    store.save_full(4, full_state(4))
    for s in (5, 6, 7):
        store.save_diff(s, pay(s))
    corrupt_file_tail(os.path.join(root, "diff_00000006.ckpt"))
    svc = MaintenanceService(store)
    store.attach_maintenance(svc)
    svc.start()
    svc.request_scrub()
    store.flush(timeout=30.0)
    assert svc.corrupt_found == 1
    diffs = store.diffs_after(4)
    assert [s for s, _ in diffs] == [5, 7]
    assert [s for s, _ in rec.contiguous_prefix(4, diffs)] == [5]
    assert store.drop_quarantined() == 1
    assert not store.backend.exists("diff_00000006")
    store.close()


def test_scrub_crash_then_resume_completes(tmp_path):
    root = tmp_path / "scrubcrash"
    store = make(root)
    build_chain(store, fulls=(4, 8))
    corrupt_file_tail(os.path.join(root, "diff_00000007.ckpt"))
    svc = MaintenanceService(store, scrub_slice=2)
    store.attach_maintenance(svc)
    kill_at(svc, "scrub:cursored")
    svc.start()
    svc.request_scrub()
    wait_dead(svc)
    store.journal.close()
    store2 = make(root)
    svc2 = MaintenanceService(store2, scrub_slice=2)
    store2.attach_maintenance(svc2)
    svc2.start()
    svc2.drain(30.0)
    assert svc2.resumed == 1
    assert [e["key"] for e in store2.manifest["quarantined"]] == \
        ["diff_00000007"]
    store2.close()


def test_scrub_remote_chunk_corruption_quarantined(tmp_path):
    obj = FakeObjectStore()
    be = RemoteObjectBackend(obj, chunk_bytes=256,
                             journal_root=str(tmp_path / "rj"))
    store = CheckpointStore(backend=be)
    store.save_full(4, full_state(4))
    store.save_full(8, full_state(8))
    name = next(n for n in obj.list_objects("full_00000008/")
                if n.endswith(".chunk"))
    obj._objects[name] = b"\xff" + obj._objects[name][1:]
    svc = MaintenanceService(store)
    store.attach_maintenance(svc)
    svc.start()
    svc.request_scrub()
    store.flush(timeout=30.0)
    assert svc.corrupt_found == 1
    assert store.manifest["quarantined"][0]["key"] == "full_00000008"
    assert store.latest_full()["step"] == 4
    store.close()


class TransientVerifyBackend(LocalFSBackend):
    """The first verify() fails like a flaky remote wire."""

    def __init__(self, root):
        super().__init__(root)
        self.flaked = 0

    def verify(self, key):
        if self.flaked == 0:
            self.flaked += 1
            raise RetryExhaustedError("injected transient exhaustion")
        return super().verify(key)


def test_transient_verify_error_does_not_poison_worker(tmp_path):
    store = CheckpointStore(
        backend=TransientVerifyBackend(str(tmp_path / "flaky")))
    build_chain(store, fulls=(4, 8))
    svc = MaintenanceService(store)
    store.attach_maintenance(svc)
    svc.start()
    svc.request_scrub()
    store.flush(timeout=30.0)
    assert svc.error is None and svc.running
    assert svc.scrub_transient_skips == 1
    assert svc.scrubbed == 7
    assert store.manifest.get("quarantined", []) == []
    store.close()


# ----------------------------------------------------------------------
# the orphan sweep against a put in flight
# ----------------------------------------------------------------------

class GatedBucket(FakeObjectStore):
    """An object store that holds the second chunk put of ``key`` open."""

    def __init__(self, key):
        super().__init__()
        self.key = key
        self.seen = 0
        self.entered = threading.Event()
        self.release = threading.Event()

    def put_object(self, name, data):
        if name.startswith(self.key + "/") and name.endswith(".chunk"):
            self.seen += 1
            if self.seen == 2:
                self.entered.set()
                assert self.release.wait(30.0)
        return super().put_object(name, data)


def _gated_local(tmp_path):
    """A local store whose first frame write holds open (its temporary
    file on disk) until released, and a crashed write's debris."""
    store = CheckpointStore(str(tmp_path / "loc"))
    held, release = threading.Event(), threading.Event()
    write_frame = cio.write_frame

    def slow_write(f, payload, extra=None):
        write_frame(f, payload, extra)
        f.flush()
        if not held.is_set():
            held.set()
            assert release.wait(30.0)
    debris = os.path.join(store.root, "diff_00000099.ckpt.dead.tmp")
    return store, held, release, slow_write, debris


@pytest.mark.parametrize("tier", ["local", "remote"])
def test_orphan_sweep_spares_a_put_in_flight(tmp_path, monkeypatch, tier):
    """A sweep with no age gate, run while a full's put is held open,
    removes crashed debris but not the upload in flight, and the put
    then lands and reads back."""
    if tier == "local":
        store, held, release, slow_write, debris = _gated_local(tmp_path)
        monkeypatch.setattr(cio, "write_frame", slow_write)
        with open(debris, "wb") as f:
            f.write(b"crashed half-write")
    else:
        bucket = GatedBucket("full_00000004")
        store = CheckpointStore(backend=RemoteObjectBackend(
            bucket, chunk_bytes=64, journal_root=str(tmp_path / "rj")))
        held, release = bucket.entered, bucket.release
        bucket.put_object("full_00000099/dead.000000.chunk", b"x" * 8)
    t = threading.Thread(target=store.save_full, args=(4, full_state(4)))
    t.start()
    try:
        assert held.wait(30.0)
        assert store.sweep_orphans(min_age_s=0) == 1
    finally:
        release.set()
        t.join(30.0)
    monkeypatch.undo()
    got = store.load_full(store.latest_full())
    np.testing.assert_array_equal(got["params"]["g"], pay(4)["g"])
    if tier == "local":
        assert not os.path.exists(debris)
        assert not [f for f in os.listdir(store.root) if f.endswith(".tmp")]
    store.close()


# ----------------------------------------------------------------------
# service lifecycle, flush() contract
# ----------------------------------------------------------------------

def test_service_stop_then_start_resumes_journaled_work(tmp_path):
    store = make(tmp_path / "stopstart")
    build_chain(store)
    svc = MaintenanceService(store, gc_slice=2)
    store.attach_maintenance(svc)
    kill_at(svc, "gc:cursored")
    svc.start()
    svc.request_gc(2)
    wait_dead(svc)
    svc.stop()
    svc.crash_hook = None
    svc.start()
    svc.drain(30.0)
    assert svc.error is None
    assert_no_leak_no_loss(store)
    assert [e["step"] for e in store.manifest["fulls"]] == [12, 16]
    store.close()


def test_progress_journal_is_host_scoped(tmp_path):
    root = str(tmp_path / "hosts")
    s0 = CheckpointStore(backend=LocalFSBackend(root), host_id="h0")
    s1 = CheckpointStore(backend=LocalFSBackend(root), host_id="h1")
    svc0, svc1 = MaintenanceService(s0), MaintenanceService(s1)
    assert os.path.basename(svc0.progress.path) == "maintenance.h0.log"
    assert os.path.basename(svc1.progress.path) == "maintenance.h1.log"
    svc1.progress.append({"task": "gc", "id": 1, "op": "plan",
                          "doomed": [["diffs", "diff_00000001"]]})
    svc0.progress.append({"task": "gc", "id": 1, "op": "plan",
                          "doomed": []})
    svc0.progress.append({"task": "gc", "id": 1, "op": "done"})
    svc0.progress.compact_if_idle()
    assert svc1.progress.pending() != []
    svc0.progress.close()
    svc1.progress.close()
    s0.close()
    s1.close()


def test_progress_torn_tail_is_dropped(tmp_path):
    from repro_torch.maintenance import ProgressJournal
    root = str(tmp_path / "torn")
    pj = ProgressJournal(root)
    pj.append({"task": "gc", "id": 1, "op": "plan", "doomed": [["d", "k"]]})
    pj.append({"task": "gc", "id": 1, "op": "cursor", "pos": 1})
    pj.close()
    with open(pj.path, "a", encoding="utf-8") as f:
        f.write('{"task": "gc", "id": 1, "op": "do')
    pj2 = ProgressJournal(root)
    assert [(r["id"], r["pos"]) for r in pj2.pending()] == [(1, 1)]
    pj2.append({"task": "gc", "id": 1, "op": "done"})
    pj2.close()
    assert ProgressJournal(root).pending() == []


class ExplodingDeleteBackend(LocalFSBackend):
    def delete(self, key):
        raise RuntimeError("disk on fire")


def test_store_flush_surfaces_maintenance_error(tmp_path):
    store = CheckpointStore(
        backend=ExplodingDeleteBackend(str(tmp_path / "boom")))
    build_chain(store, fulls=(4, 8))
    svc = MaintenanceService(store, gc_slice=2)
    store.attach_maintenance(svc)
    svc.start()
    svc.request_gc(1)
    with pytest.raises(CheckpointingError, match="maintenance"):
        store.flush(timeout=10.0)
    store.attach_maintenance(None)
    svc.stop()
    store.close()


def test_store_flush_times_out_instead_of_hanging(tmp_path):
    store = make(tmp_path / "hang")
    build_chain(store, fulls=(4, 8))
    svc = MaintenanceService(store, gc_slice=1)
    store.attach_maintenance(svc)
    svc.request_gc(1)          # never started: nothing can drain
    with pytest.raises(CheckpointingError, match="not running"):
        store.flush(timeout=0.5)
    store.attach_maintenance(None)
    store.close()


# ----------------------------------------------------------------------
# the fold on the service
# ----------------------------------------------------------------------

def patched_store(store):
    """A base full with a name map and five patches of whole leaves and
    row spans; returns (base key, the state the chain represents)."""
    from repro_torch.checkpoint.patchset import RowUpdate
    rng = np.random.default_rng(0)
    state = {"params": {"w": rng.standard_normal((16, 4)).astype(np.float32),
                        "b": rng.standard_normal(4).astype(np.float32)},
             "step": np.int32(0)}
    base = store.save_full(0, state, record_names=True)
    want = {k: v.copy() for k, v in state["params"].items()}
    for step in range(1, 6):
        rows = rng.standard_normal((2, 4)).astype(np.float32)
        start = (3 * step) % 14
        want["w"][start:start + 2] = rows
        want["b"] = want["b"] + np.float32(step)
        store.save_patch(step, base, {"params": {
            "w": RowUpdate(np.asarray([start], np.int64), [rows], (16, 4)),
            "b": want["b"].copy()}})
    return base, want


@pytest.mark.parametrize("point", ["fold:planned", "fold:patched_slice",
                                   "fold:cursored", "fold:folded"])
def test_crash_at_fold_boundaries_resumes(tmp_path, point):
    root = tmp_path / "f"
    store = make(root)
    base, want = patched_store(store)
    svc = MaintenanceService(store, merge_slice=1)
    store.attach_maintenance(svc)
    kill_at(svc, point)
    svc.start()
    store.request_fold()
    wait_dead(svc)
    svc.stop()
    store.journal.close()
    store2 = make(root)
    svc2 = MaintenanceService(store2, merge_slice=1)
    store2.attach_maintenance(svc2)
    svc2.start()
    svc2.drain(30.0)
    assert svc2.resumed == 1 and svc2.fold_runs == 1
    assert store2.manifest.get("patches", []) == []
    assert not any(k.startswith("patch_") for k in store2.backend.keys())
    entry = store2.latest_full()
    assert entry["state_step"] == 5
    got = store2.load_full(entry)["params"]
    for k in want:
        assert np.asarray(got[k]).tobytes() == want[k].tobytes()
    assert store2.backend.verify(base) is None
    store2.close()


def test_concurrent_writers_gc_and_scrub_lose_nothing(tmp_path):
    """Eight writer threads save differentials and fulls while the
    service runs retention GC and scrubs, with a short switch interval:
    afterwards the disk holds exactly what the manifest references, and
    the newest full's chain is whole."""
    import sys
    store = make(tmp_path / "c", retention=1)
    svc = MaintenanceService(store, gc_slice=2, scrub_slice=3)
    store.attach_maintenance(svc)
    svc.start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors = []

    def writer(t):
        try:
            for j in range(6):
                step = 1 + t + 8 * j
                store.save_diff(step, pay(step))
                if step % 4 == 0 and step <= 40:
                    store.save_full(step, full_state(step))
                if step % 7 == 0:
                    svc.request_scrub()
        except BaseException as e:   # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    store.request_gc()
    store.flush(timeout=60.0)
    assert svc.error is None and svc.stats()["corrupt_found"] == 0
    assert_no_leak_no_loss(store)
    newest = store.latest_full()["step"]
    assert newest == 40
    assert [e["step"] for e in store.manifest["fulls"]] == [40]
    assert sorted(s for s, _ in store.diffs_after(newest)) == list(
        range(41, 49))
    store.close()


# ----------------------------------------------------------------------
# across the packages
# ----------------------------------------------------------------------

def _mixed_chain(store):
    """Fulls with diffs, batches and a straddling batch."""
    for step in (4, 8, 12):
        store.save_diff(step - 3, pay(step - 3))
        store.save_batch(step - 2, step - 1, [pay(step - 2), pay(step - 1)])
        store.save_full(step, full_state(step))
    store.save_batch(12, 14, [pay(12), pay(13), pay(14)])
    store.save_diff(15, pay(15))


@pytest.mark.parametrize("keep", [1, 2, 3, 4])
def test_gc_plan_matches_the_reference(tmp_path, keep):
    mine, ref = make(tmp_path / "p"), make_ref(tmp_path / "r")
    _mixed_chain(mine)
    _mixed_chain(ref)
    assert mine.gc_plan(keep) == ref.gc_plan(keep)
    assert mine._live_chain_keys(keep) == ref._live_chain_keys(keep)
    assert mine.gc(keep) == ref.gc(keep)
    assert manifest_keys(mine) == manifest_keys(ref)
    mine.close()
    ref.close()


def _service(store, pkg, **kw):
    cls = MaintenanceService if pkg == "port" else JaxService
    svc = cls(store, **kw)
    store.attach_maintenance(svc)
    return svc


@pytest.mark.parametrize("task,point", [("gc", "gc:swept_slice"),
                                        ("gc", "gc:mid_delete"),
                                        ("scrub", "scrub:cursored"),
                                        ("fold", "fold:patched_slice")])
@pytest.mark.parametrize("first", ["ref", "port"])
def test_half_done_task_is_finished_by_the_other_package(tmp_path, first,
                                                         task, point):
    """One package's worker dies mid-task with its plan journaled in
    ``maintenance.log``; the other package's service resumes the plan
    from its cursor and finishes it."""
    root = tmp_path / "x"
    opener = {"port": make, "ref": make_ref}
    second = "ref" if first == "port" else "port"
    store = opener[first](root)
    if task == "fold":
        want = _whole_leaf_chain(store)
    else:
        build_chain(store)
    if task == "scrub":
        corrupt_file_tail(os.path.join(root, "diff_00000010.ckpt"))
    svc = _service(store, first, gc_slice=2, scrub_slice=2, merge_slice=1)
    kill_at(svc, point, InjectedCrash if first == "port"
            else JaxInjectedCrash)
    svc.start()
    {"gc": lambda: svc.request_gc(2), "scrub": svc.request_scrub,
     "fold": svc.request_fold}[task]()
    wait_dead(svc)
    svc.progress.close()
    store.journal.close()
    assert svc.progress.pending()

    store2 = opener[second](root)
    svc2 = _service(store2, second, gc_slice=2, scrub_slice=2, merge_slice=1)
    svc2.start()
    svc2.drain(30.0)
    assert svc2.resumed == 1 and svc2.progress.pending() == []
    if task == "fold":
        entry = store2.latest_full()
        assert entry["state_step"] == 3 and not store2.manifest["patches"]
        got = store2.load_full(entry)["params"]
        for k in want:
            assert np.asarray(got[k]).tobytes() == want[k].tobytes()
        store2.close()
        return
    if task == "gc":
        assert [e["step"] for e in store2.manifest["fulls"]] == [12, 16]
        assert [s for s, _ in store2.diffs_after(12)] == [13, 14, 15]
    else:
        assert [e["key"] for e in store2.manifest["quarantined"]] == \
            ["diff_00000010"]
    assert_no_leak_no_loss(store2)
    store2.close()


def _whole_leaf_chain(store):
    """A base full with a name map and three whole-leaf patches (the
    form both packages' patch blobs share); returns the final leaves."""
    rng = np.random.default_rng(1)
    params = {k: rng.standard_normal(n).astype(np.float32)
              for k, n in (("a", 8), ("b", 5), ("c", 3))}
    base = store.save_full(0, {"params": params, "step": np.int32(0)},
                           record_names=True)
    want = {k: v.copy() for k, v in params.items()}
    for step, k in ((1, "a"), (2, "c"), (3, "a")):
        want[k] = want[k] + np.float32(step)
        store.save_patch(step, base, {"params": {k: want[k].copy()}})
    return want


def _state_equal(a, b):
    assert int(a["step"]) == int(b["step"])
    np.testing.assert_array_equal(np.asarray(a["params"]["g"]),
                                  np.asarray(b["params"]["g"]))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_maintained_segmented_dir_recovers_in_the_other_package(tmp_path,
                                                                writer):
    """A chain written with a host id, retention 1 and the service on
    (GC journaled in the segment, a merge run) loads the same in both
    packages, bitwise."""
    root = tmp_path / "m"
    store = (make if writer == "port" else make_ref)(root, 1, "h0")
    svc = _service(store, writer, gc_slice=3)
    svc.start()
    build_chain(store)
    store.save_diff(17, pay(17))
    svc.request_merge()
    store.flush(timeout=30.0)
    assert svc.gc_runs >= 1 and svc.merge_runs == 1
    store.save_diff(18, pay(18))           # after the merge: in a segment
    store.close()
    mine = make(root, host_id="rd")
    ref = make_ref(root, host_id="rd2")
    (sa, da), (sb, db) = (rec.load_latest_chain(mine),
                          jax_rec.load_latest_chain(ref))
    _state_equal(sa, sb)
    assert int(sa["step"]) == 16
    assert [s for s, _ in da] == [s for s, _ in db] == [17, 18]
    for (_, a), (_, b) in zip(da, db):
        np.testing.assert_array_equal(np.asarray(a["g"]), np.asarray(b["g"]))
    assert manifest_keys(mine) == manifest_keys(ref)
    mine.close()
    ref.close()


# ----------------------------------------------------------------------
# LowDiff with the service, and the CLI
# ----------------------------------------------------------------------

def test_lowdiff_with_maintenance_service(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.core.lowdiff import LowDiff
    from repro_torch.core.steps import init_state
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.registry import build_model
    store = make(tmp_path / "ld", retention=1)
    svc = MaintenanceService(store, gc_slice=4)
    store.attach_maintenance(svc)
    svc.start()
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    ld = LowDiff(model, store, rho=0.05, lr=1e-3, full_interval=3,
                 batch_size=2, device="cpu", parallel_recovery=False)
    state = init_state(model, 0, mode="lowdiff", device="cpu")
    stream = TokenStream(cfg, 32, 2, seed=0, device="cpu")
    for _ in range(8):
        state, _ = ld.train_step(state, next(stream))
    ld.flush()
    assert svc.gc_runs >= 1
    assert_no_leak_no_loss(store)
    got, n = ld.recover()
    assert int(got["step"]) == 8 and n == 2
    for a, b in zip(rec_leaves(got), rec_leaves(state)):
        assert torch.equal(a, b)
    assert store.stats()["maintenance"]["pending"] == 0
    ld.close()
    assert not svc.running
    assert store.stats()["maintenance"]["gc_runs"] >= 1


@pytest.mark.parametrize("replay_device", [True, False])
def test_quarantined_newest_batch_cuts_recovery_to_the_full(tmp_path,
                                                           replay_device):
    """LowDiff, f 2, b 2, steps 2..5, retention 1, the service on: one
    flipped byte in the newest batch is quarantined by the scrub, and
    recovery cuts the chain there, returning the step-4 full's state as
    tensors on the strategy's device (no differential to replay),
    bitwise equal to the state kept at step 4."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.lowdiff import LowDiff
    from repro_torch.core.steps import init_state
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.registry import build_model
    root = tmp_path / "q"
    store = EngineConfig(maintenance=True, store=StoreConfig(
        str(root), retention_fulls=1)).build_store()
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    ld = LowDiff(model, store, rho=0.05, lr=1e-3, full_interval=2,
                 batch_size=2, device="cpu", replay_device=replay_device)
    state = init_state(model, 0, mode="lowdiff", device="cpu")
    state["step"] = torch.tensor(1, dtype=torch.int32)
    stream = TokenStream(cfg, 32, 2, seed=0, device="cpu")
    for i in range(4):
        state, _ = ld.train_step(state, next(stream))
        if i == 2:
            kept = [t.clone() for t in rec_leaves(state)]
    ld.flush()
    newest = max(store.manifest["batches"], key=lambda e: e["last"])["key"]
    assert newest == "batch_00000004_00000005"
    path = os.path.join(root, f"{newest}.ckpt")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(os.path.getsize(path) // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    store.maintenance.request_scrub()
    store.flush(timeout=30.0)
    assert [e["key"] for e in store.manifest["quarantined"]] == [newest]
    got, n = ld.recover()
    assert (int(got["step"]), n) == (4, 0)
    leaves = rec_leaves(got)
    assert all(isinstance(t, torch.Tensor) for t in leaves)
    assert all(torch.equal(a, b) for a, b in zip(leaves, kept))
    ld.close()


def rec_leaves(state):
    from repro_torch import tree_leaves
    return tree_leaves(state["params"]) + tree_leaves(state["opt"])


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _cli(argv):
    from repro_torch.launch.train import build_parser, run
    lines = Lines()
    logger = logging.getLogger("repro_torch")
    logger.addHandler(lines)
    try:
        losses, _ = run(build_parser().parse_args(argv))
    finally:
        logger.removeHandler(lines)
    assert len(losses) and all(np.isfinite(losses))
    stats = next(m for m in lines.lines if m.startswith("strategy stats: "))
    return lines.lines, ast.literal_eval(stats[len("strategy stats: "):])


BASE = ["--device", "cpu", "--arch", "gpt2-l", "--reduced", "--log-every",
        "0", "--maintenance", "on", "--retention", "1", "--peers", "2",
        "--host-id", "h0"]


def test_train_cli_with_maintenance_and_peers_recovers(tmp_path):
    from repro_torch.checkpoint.peer import reset_hub
    reset_hub("default")
    lines, stats = _cli(BASE + ["--steps", "10", "--full-interval", "3",
                                "--fail-at", "8", "--ckpt-dir",
                                str(tmp_path / "ck")])
    reset_hub("default")
    assert any("recovered at step 8; resuming" in m for m in lines)
    st = stats["store"]
    assert st["gc_deleted"] > 0 and st["quarantined"] == 0
    assert st["fulls"] == 1
    assert st["maintenance"]["gc_runs"] >= 1
    assert st["maintenance"]["error"] is None
    assert st["backend"]["backend"] == "peer"
    assert st["backend"]["acks_total"] > 0
    assert st["journal"]["host"] == "h0"
    assert os.path.exists(tmp_path / "ck" / "manifest.h0.log")


def test_train_cli_lowdiff_plus_folds_on_the_service(tmp_path):
    from repro_torch.checkpoint.peer import reset_hub
    reset_hub("default")
    lines, stats = _cli(BASE + [
        "--strategy", "lowdiff_plus", "--persist-mode", "incremental",
        "--dirty-granularity", "row", "--diff-quant", "int4",
        "--fold-interval", "2", "--steps", "8", "--fail-at", "6",
        "--ckpt-dir", str(tmp_path / "ck")])
    reset_hub("default")
    assert any("recovered at step 6; resuming" in m for m in lines)
    st = stats["store"]
    assert st["maintenance"]["fold_runs"] >= 1
    assert st["folds"] == st["maintenance"]["fold_runs"]
    assert st["maintenance"]["folded_patches"] >= 2


def test_train_cli_dir_recovers_bitwise_in_the_reference(tmp_path):
    """A directory the port's CLI wrote with --host-id h0, --retention 1
    and --maintenance on loads the same chain, bitwise, in both
    packages."""
    from repro_torch.checkpoint.peer import reset_hub
    reset_hub("default")
    root = tmp_path / "ck"
    _cli(BASE[:-4] + ["--host-id", "h0", "--steps", "9",
                      "--full-interval", "4", "--ckpt-dir", str(root)])
    mine = make(root, host_id="rd")
    ref = make_ref(root, host_id="rd")
    (sa, da), (sb, db) = (rec.load_latest_chain(mine),
                          jax_rec.load_latest_chain(ref))
    assert int(sa["step"]) == int(sb["step"]) == 8
    assert [e["step"] for e in mine.manifest["fulls"]] == [8]
    assert [s for s, _ in da] == [s for s, _ in db] == [9]
    from repro.checkpoint import io as jax_cio
    for mine_tree, ref_tree in [(sa, sb)] + [(a, b) for (_, a), (_, b)
                                              in zip(da, db)]:
        xs, ys = cio.pack(mine_tree)[1], jax_cio.pack(ref_tree)[1]
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    mine.close()
    ref.close()
    shutil.rmtree(root)
