"""The port's peer-memory tier against the JAX reference's: the wire
frames (byte-identical ``encode_message``), failure-domain placement,
asynchronous replication with acks, retries and a bounded window, the
socket transport, replicas that own their bytes, recovery of a killed
host's chain from a surviving peer (a LowDiff run too), adoption that
never shadows a newer durable full, replica pruning by the maintenance
service, and the port replicating over TCP to a reference peer from
which a reference replacement host recovers bitwise (small trees, on the
CPU, sockets on 127.0.0.1 with timeouts)."""
import shutil

import numpy as np
import pytest
import torch

from repro.checkpoint import peer as jax_peer
from repro.checkpoint.backends import LocalFSBackend as JaxLocal
from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.core.recovery import load_latest_chain as jax_load_latest_chain
from repro_torch.checkpoint import io as cio
from repro_torch.checkpoint.backends import LocalFSBackend
from repro_torch.checkpoint.config import StoreConfig, TierSpec
from repro_torch.checkpoint.patchset import PatchSet
from repro_torch.checkpoint.peer import (ACK, CATALOG, DATA, DEL, GET, HAS,
                                         MGET, MISS, MREC, PATCH, PUT,
                                         LoopbackTransport, PeerGroup,
                                         PeerHub, PeerInfo, PeerNode,
                                         PeerProtocolError,
                                         PeerReplicaBackend, PeerServer,
                                         PeerUnreachableError,
                                         SocketTransport, decode_message,
                                         encode_message, get_hub, reset_hub)
from repro_torch.checkpoint.remote import ChecksumError, FaultInjector
from repro_torch.checkpoint.store import CheckpointStore, order_fulls
from repro_torch.core.recovery import load_latest_chain
from repro_torch.maintenance import MaintenanceService


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


def payload(seed, n=256):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(n).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}


def tree_equal(a, b):
    ka, kb = sorted(a), sorted(b)
    return ka == kb and all(np.asarray(a[k]).tobytes() ==
                            np.asarray(b[k]).tobytes() for k in ka)


# ----------------------------------------------------------------------
# wire framing
# ----------------------------------------------------------------------

def test_message_roundtrip():
    wire = encode_message(PUT, "full_00000001", {"src": "h0"}, b"\x01\x02")
    assert decode_message(wire) == (PUT, "full_00000001", {"src": "h0"},
                                    b"\x01\x02")


def test_message_checksum_corruption_detected():
    wire = bytearray(encode_message(PUT, "k", {}, b"payload"))
    wire[-10] ^= 0xFF
    with pytest.raises(ChecksumError):
        decode_message(bytes(wire))
    wire2 = bytearray(encode_message(PUT, "k", {}, b"payload"))
    wire2[len(wire2) // 2] ^= 0xFF
    with pytest.raises(ChecksumError):
        decode_message(bytes(wire2))


def test_message_protocol_damage_detected():
    with pytest.raises(PeerProtocolError):
        decode_message(b"short")
    wire = encode_message(PUT, "k", {}, b"p")
    with pytest.raises(PeerProtocolError):
        decode_message(b"XXXXXXXX" + wire[8:])
    with pytest.raises(PeerProtocolError):
        decode_message(wire + b"extra")


MESSAGES = [
    (PUT, "full_00000001", {"src": "h0", "kind": "fulls", "nbytes": 7},
     b"\x00frame\xff"),
    (PATCH, "full_00000004", {"src": "h0", "state_step": 9}, b"x" * 300),
    (DEL, "diff_00000003", {"src": "h1"}, b""),
    (GET, "batch_00000002_00000003", {"src": "h0", "zc": True}, b""),
    (HAS, "patch_00000005", None, b""),
    (CATALOG, "", {"src": "h0"}, b""),
    (MREC, "", {"src": "h0"},
     b'[{"rseq": 1, "op": "add", "kind": "fulls", "entry": {"k": "\\u00e9"}}]'),
    (MGET, "", {"src": "h0"}, b""),
    (ACK, "kéy", {"node": "p1", "existed": False}, b""),
    (DATA, "", {}, b"\x01" * 70_000),
    (MISS, "k", {"node": "p2"}, b""),
]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_encode_message_bytes_equal_the_reference(i):
    kind, key, meta, body = MESSAGES[i]
    wire = encode_message(kind, key, meta, body)
    assert wire == jax_peer.encode_message(kind, key, meta, body)
    assert jax_peer.decode_message(wire) == decode_message(wire)


def test_patch_wire_tree_equals_the_reference():
    from repro.checkpoint.patchset import PatchSet as JaxPatchSet
    mine, ref = PatchSet(), JaxPatchSet()
    for ps in (mine, ref):
        ps.add("a1", 2, np.arange(6, dtype=np.float32).reshape(2, 3),
               (8, 3))
        ps.add("a1", 5, np.ones((1, 3), np.float32), (8, 3))
        ps.add("a0", 0, np.float32(7.0))
    a, b = cio.frame_dumps(mine.to_tree()), cio.frame_dumps(ref.to_tree())
    assert a == b
    back = PatchSet.from_tree(cio.frame_loads(b))
    assert back.names() == ["a0", "a1"] and back.nbytes == mine.nbytes


# ----------------------------------------------------------------------
# placement
# ----------------------------------------------------------------------

def test_peer_selection_prefers_foreign_domains():
    hub = PeerHub("sel")
    for nid, dom in (("a", "dA"), ("b", "dB"), ("c", "dA"),
                     ("d", "dC"), ("e", "dB")):
        hub.ensure(nid, dom)
    group = PeerGroup("a", "dA", hub=hub)
    assert group.select(2) == ["b", "d"]
    assert "c" in group.select(4)
    assert len(group.select(10)) == 4
    ref_hub = jax_peer.PeerHub("sel")
    for m in hub.members():
        ref_hub.ensure(m.node_id, m.domain)
    ref = jax_peer.PeerGroup("a", "dA", hub=ref_hub)
    assert all(group.select(k) == ref.select(k) for k in range(6))


def test_peer_selection_is_deterministic():
    hub = PeerHub("det")
    for nid in ("n3", "n1", "n2"):
        hub.ensure(nid, "dX")
    group = PeerGroup("n1", "dX", hub=hub)
    assert group.select(2) == group.select(2) == ["n2", "n3"]
    static = PeerGroup("n1", "dX", members=[PeerInfo("n2", "dY")])
    assert static.select(3) == ["n2"]


# ----------------------------------------------------------------------
# loopback replication
# ----------------------------------------------------------------------

def make_peer_backend(tmp_path, *, replicas=2, faults=None, hubname="t",
                      zero_copy=False, window=8, max_retries=3):
    hub = PeerHub(hubname)
    hub.ensure("self", "d0")
    hub.ensure("p1", "d1")
    hub.ensure("p2", "d2")
    transport = LoopbackTransport(hub, faults=faults, zero_copy=zero_copy)
    group = PeerGroup("self", "d0", hub=hub)
    lower = LocalFSBackend(str(tmp_path / "lower"))
    be = PeerReplicaBackend(lower, transport, group, replicas=replicas,
                            window=window, max_retries=max_retries,
                            backoff_s=0.001, backoff_max_s=0.01)
    return be, hub


@pytest.mark.parametrize("zero_copy", [False, True])
def test_put_replicates_to_k_peers(tmp_path, zero_copy):
    be, hub = make_peer_backend(tmp_path, zero_copy=zero_copy)
    be.put("full_00000001", payload(1))
    be.flush()
    assert be.ack_count("full_00000001") == 2
    for nid in ("p1", "p2"):
        cat = hub.node(nid).catalog()
        assert cat["full_00000001"]["src"] == "self"
        assert cat["full_00000001"]["kind"] == "fulls"
    assert be.unreplicated_keys() == []
    assert be.stats()["acks_total"] == 2
    be.close()


@pytest.mark.parametrize("zero_copy", [False, True])
def test_get_falls_back_to_peer_after_local_loss(tmp_path, zero_copy):
    be, _ = make_peer_backend(tmp_path, zero_copy=zero_copy)
    obj = payload(2)
    be.put("diff_00000003", obj)
    be.flush()
    be.lower.delete("diff_00000003")
    assert tree_equal(be.get("diff_00000003"), obj)
    assert be.exists("diff_00000003")
    assert be.stats()["peer_reads"] == 1
    be.close()


@pytest.mark.parametrize("zero_copy", [False, True])
def test_a_replica_owns_its_bytes(tmp_path, zero_copy):
    """The caller overwrites its arrays after ``put`` (as the snapshot
    arena reuses pinned blocks): the peers still serve the bytes that
    were put, once the local blob is gone, and no reader can write into
    a replica."""
    be, hub = make_peer_backend(tmp_path, zero_copy=zero_copy)
    obj = payload(3)
    want = {k: v.copy() for k, v in obj.items()}
    be.put("full_00000002", obj)
    for v in obj.values():
        v[...] = -1.0                       # the next snapshot's bytes
    be.flush()
    be.lower.delete("full_00000002")
    got = be.get("full_00000002")
    assert tree_equal(got, want)
    if zero_copy:
        with pytest.raises(ValueError):
            got["w"][0] = 5.0               # read-only: the peers' copy
        first = hub.node("p1")._blobs["full_00000002"][1]
        assert first is hub.node("p2")._blobs["full_00000002"][1]
    assert tree_equal(be.get("full_00000002"), want)
    be.close()


@pytest.mark.parametrize("zero_copy", [False, True])
def test_a_patch_replica_owns_its_bytes(tmp_path, zero_copy):
    be, _ = make_peer_backend(tmp_path, zero_copy=zero_copy)
    obj = payload(4)
    be.put("full_00000001", obj)
    be.flush()
    idx = next(i for i, a in enumerate(cio.pack(obj)[1])
               if a.shape == obj["w"].shape)
    rows = np.full(8, 7.5, np.float32)
    be.patch("full_00000001",
             PatchSet().add(f"a{idx}", 4, rows, obj["w"].shape))
    rows[...] = 0.0                         # the caller reuses its rows
    be.flush()
    be.lower.delete("full_00000001")
    want = obj["w"].copy()
    want[4:12] = 7.5
    assert np.asarray(be.get("full_00000001")["w"]).tobytes() == \
        want.tobytes()
    be.close()


def test_transient_fault_is_retried(tmp_path):
    be, _ = make_peer_backend(tmp_path, faults=FaultInjector(drop_puts=1))
    be.put("full_00000001", payload(3))
    be.flush()
    st = be.stats()
    assert st["retries"] >= 1 and st["replication_failures"] == 0
    assert be.ack_count("full_00000001") == 2
    be.close()


def test_dead_peers_count_as_failures_not_errors(tmp_path):
    be, hub = make_peer_backend(tmp_path)
    hub.node("p1").kill()
    hub.node("p2").kill()
    be.put("full_00000001", payload(4))
    be.flush()
    st = be.stats()
    assert st["replication_failures"] == 2
    assert be.unreplicated_keys() == ["full_00000001"]
    hub.node("p1").revive()
    be.put("full_00000002", payload(5))
    be.flush()
    assert be.ack_count("full_00000002") == 1
    be.close()


def test_inline_zero_copy_failure_falls_back_to_async_retry(tmp_path):
    be, _ = make_peer_backend(tmp_path, faults=FaultInjector(drop_puts=1),
                              zero_copy=True)
    be.put("full_00000001", payload(5))
    be.flush()
    assert be.stats()["replication_failures"] == 0
    assert be.ack_count("full_00000001") == 2
    be.close()


@pytest.mark.parametrize("zero_copy", [False, True])
def test_patch_forwarded_to_peer_replicas(tmp_path, zero_copy):
    be, _ = make_peer_backend(tmp_path, zero_copy=zero_copy)
    obj = payload(6)
    be.put("full_00000001", obj)
    be.flush()
    new_w = np.full_like(obj["w"], 7.5)
    idx = next(i for i, a in enumerate(cio.pack(obj)[1])
               if a.shape == obj["w"].shape)
    be.patch("full_00000001", PatchSet().add(f"a{idx}", 0, new_w))
    be.flush()
    assert np.array_equal(np.asarray(be.get("full_00000001")["w"]), new_w)
    be.lower.delete("full_00000001")
    assert np.array_equal(np.asarray(be.get("full_00000001")["w"]), new_w)
    be.close()


def test_delete_broadcast_prunes_replicas(tmp_path):
    be, hub = make_peer_backend(tmp_path)
    be.put("diff_00000001", payload(7))
    be.flush()
    be.delete("diff_00000001")
    be.flush()
    for nid in ("p1", "p2"):
        assert "diff_00000001" not in hub.node(nid).catalog()
    assert be.ack_count("diff_00000001") == 0
    be.close()


# ----------------------------------------------------------------------
# socket transport
# ----------------------------------------------------------------------

def test_socket_transport_roundtrip():
    node = PeerNode("srv", "d1")
    server = PeerServer(node)
    try:
        transport = SocketTransport({"srv": server.address}, timeout_s=5.0)
        obj = payload(8)
        blob = cio.frame_dumps(obj)
        rk, _, rmeta, _ = transport.request(
            "srv", PUT, "full_00000001",
            {"src": "h0", "nbytes": len(blob)}, blob)
        assert rk == ACK and rmeta["node"] == "srv"
        rk, _, _, body = transport.request("srv", GET, "full_00000001",
                                           {"src": "h0"}, b"")
        assert rk == DATA and tree_equal(cio.frame_loads(body), obj)
        rk, _, _, _ = transport.request("srv", GET, "missing",
                                        {"src": "h0"}, b"")
        assert rk == MISS
        transport.close()
    finally:
        server.close()


def test_socket_transport_killed_peer_unreachable():
    node = PeerNode("srv", "d1")
    server = PeerServer(node)
    try:
        transport = SocketTransport({"srv": server.address}, timeout_s=2.0)
        node.kill()
        with pytest.raises(PeerUnreachableError):
            transport.request("srv", PUT, "k", {"src": "h0"}, b"x")
        with pytest.raises(PeerUnreachableError):
            transport.request("unknown", PUT, "k", {"src": "h0"}, b"x")
        transport.close()
    finally:
        server.close()


# ----------------------------------------------------------------------
# host failure -> recovery from a surviving peer
# ----------------------------------------------------------------------

def peer_store(root, hubname, node, *, replicas=2, retention=0):
    return StoreConfig(str(root), tiers=[
        TierSpec("peer", replicas=replicas, hub=hubname, node_id=node,
                 domain=f"dom_{node}", simulate_peers=True),
        TierSpec("local"),
    ], host_id=node, retention_fulls=retention).build()


def test_kill_host_mid_chain_recovers_bit_identical_from_peer(tmp_path):
    reset_hub("crash1")
    store = peer_store(tmp_path / "a", "crash1", "hostA")
    store.save_full(0, payload(10))
    for step in range(1, 6):
        store.save_diff(step, payload(100 + step))
    store.backend.flush()
    control_state, control_diffs = load_latest_chain(store)
    control_state = {k: np.array(v) for k, v in control_state.items()}
    store.close()
    get_hub("crash1").remove("hostA")
    shutil.rmtree(tmp_path / "a")
    store2 = peer_store(tmp_path / "b", "crash1", "hostB")
    assert store2.adopt_peer_manifest() == 6
    state, diffs = load_latest_chain(store2)
    assert tree_equal(state, control_state)
    assert [s for s, _ in diffs] == [s for s, _ in control_diffs]
    for (_, got), (_, want) in zip(diffs, control_diffs):
        assert tree_equal(got, want)
    assert all(e.get("tier") == "peer"
               for e in store2.manifest["fulls"] + store2.manifest["diffs"])
    assert store2.stats()["backend"]["peer_reads"] == 6
    store2.close()
    reset_hub("crash1")


def test_journal_records_replicated_and_deduped_across_peers(tmp_path):
    reset_hub("crash2")
    store = peer_store(tmp_path / "a", "crash2", "hostA")
    store.save_full(0, payload(11))
    store.save_diff(1, payload(12))
    store.backend.flush()
    manifest = store.backend.peer_manifest()
    assert len(manifest) == 2
    assert [r["op"] for _, _, r in manifest] == ["add", "add"]
    assert all(src == "hostA" for src, _, _ in manifest)
    store.close()
    reset_hub("crash2")


def test_adoption_never_shadows_newer_durable_full(tmp_path):
    reset_hub("crash3")
    store_a = peer_store(tmp_path / "a", "crash3", "hostA")
    store_a.save_full(2, payload(20))
    store_a.backend.flush()
    store_a.close()
    get_hub("crash3").remove("hostA")
    store_b = peer_store(tmp_path / "b", "crash3", "hostB")
    newer = payload(21)
    store_b.save_full(1, newer)
    store_b.manifest["fulls"][-1]["state_step"] = 9
    assert store_b.adopt_peer_manifest() >= 1
    state, _ = load_latest_chain(store_b)
    assert tree_equal(state, newer)
    store_b.close()
    reset_hub("crash3")


def test_order_fulls_ranks_state_then_step_then_durability():
    durable = {"step": 1, "state_step": 9, "path": "full_a.ckpt"}
    peer = {"step": 2, "state_step": 2, "path": "full_b.ckpt",
            "tier": "peer"}
    tie_peer = {"step": 3, "state_step": 9, "path": "full_c.ckpt",
                "tier": "peer"}
    assert order_fulls([peer, durable])[0] is durable
    assert order_fulls([durable, tie_peer])[0] is tie_peer
    dup = {"step": 3, "state_step": 9, "path": "full_d.ckpt"}
    assert order_fulls([tie_peer, dup])[0] is dup


def test_lowdiff_killed_mid_chain_recovers_bitwise_from_a_peer(tmp_path):
    """LowDiff on a reduced gpt2-l writes through the peer tier with
    retention 1 and the service; the host dies with its disk; a
    replacement host adopts the manifest and recovers params and
    moments bitwise equal to the trained ones, reading from the peers."""
    from repro_torch import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.lowdiff import LowDiff
    from repro_torch.core.steps import init_state
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.registry import build_model
    reset_hub("ld")
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    store_cfg = StoreConfig(str(tmp_path / "h0"), tiers=[
        TierSpec("peer", replicas=2, hub="ld", simulate_peers=True),
        TierSpec("local")], retention_fulls=1, host_id="h0")
    store = EngineConfig(maintenance=True, gc_slice=1,
                         store=store_cfg).build_store()
    mk = lambda st: LowDiff(model, st, rho=0.05, lr=1e-3,  # noqa: E731
                            full_interval=2, batch_size=2,
                            replay_device=True, device="cpu")
    ld = mk(store)
    state = init_state(model, 0, mode="lowdiff", device="cpu")
    state["step"] = torch.tensor(1, dtype=torch.int32)
    stream = TokenStream(cfg, 32, 2, seed=0, device="cpu")
    for _ in range(4):                       # full 2, full 4, diff 5
        state, _ = ld.train_step(state, next(stream))
    ld.flush()
    trained = [t.clone() for t in tree_leaves(state["params"])
               + tree_leaves(state["opt"])]
    assert [e["key"] for e in store.manifest["fulls"]] == ["full_00000004"]
    keep = {k for _, k in store.scrub_targets()}
    hub = get_hub("ld")
    for nid in ("sim0", "sim1"):
        assert set(hub.node(nid).catalog()) == keep
    ld.close()
    hub.remove("h0")
    shutil.rmtree(tmp_path / "h0")
    store2 = StoreConfig(str(tmp_path / "h1"), tiers=[
        TierSpec("peer", replicas=2, hub="ld", simulate_peers=True),
        TierSpec("local")], host_id="h1").build()
    assert store2.adopt_peer_manifest() > 0
    ld2 = mk(store2)
    got, n = ld2.recover()
    assert int(got["step"]) == 5 and n == 1
    leaves = tree_leaves(got["params"]) + tree_leaves(got["opt"])
    assert len(leaves) == len(trained)
    assert all(torch.equal(a, b) for a, b in zip(leaves, trained))
    assert store2.stats()["backend"]["peer_reads"] >= 2
    ld2.close()
    reset_hub("ld")


# ----------------------------------------------------------------------
# maintenance integration
# ----------------------------------------------------------------------

def test_maintenance_prunes_folded_peer_replicas(tmp_path):
    reset_hub("prune1")
    store = peer_store(tmp_path / "a", "prune1", "hostA")
    svc = MaintenanceService(store, gc_slice=8)
    store.attach_maintenance(svc)
    svc.start()
    store.save_full(0, payload(30))
    for step in range(1, 4):
        store.save_diff(step, payload(30 + step))
    store.backend.flush()
    assert len(store.backend.peer_catalog()) == 4
    store.save_full(4, payload(34))
    store.backend.flush()
    svc.request_gc(1)
    svc.drain(30.0)
    live = {key for _, key in store.scrub_targets()}
    assert set(store.backend.peer_catalog()) == live
    assert svc.stats()["peer_prune_runs"] >= 1
    store.close()
    reset_hub("prune1")


def test_peer_prune_removes_only_dead_replicas(tmp_path):
    reset_hub("prune2")
    store = peer_store(tmp_path / "a", "prune2", "hostA")
    store.save_full(0, payload(40))
    store.save_diff(1, payload(41))
    store.backend.flush()
    keep = {key for _, key in store.scrub_targets()}
    assert store.backend.prune_replicas(keep) == 0
    assert len(store.backend.peer_catalog()) == 2
    assert store.backend.prune_replicas({"full_00000000"}) == 2
    assert set(store.backend.peer_catalog()) == {"full_00000000"}
    store.close()
    reset_hub("prune2")


# ----------------------------------------------------------------------
# the port and the reference over TCP
# ----------------------------------------------------------------------

def test_port_replicates_to_a_reference_peer_server(tmp_path):
    """The port's SocketTransport replicates a chain (blobs and manifest
    records) to a reference PeerServer on 127.0.0.1; the host dies with
    its disk; a reference replacement host adopts the manifest from that
    peer and recovers the chain bitwise."""
    node = jax_peer.PeerNode("p1", "d1")
    server = jax_peer.PeerServer(node)
    try:
        addr = {"p1": server.address}
        be = PeerReplicaBackend(
            LocalFSBackend(str(tmp_path / "a")),
            SocketTransport(addr, timeout_s=5.0),
            PeerGroup("h0", "d0", members=[PeerInfo("p1", "d1")]),
            replicas=1, backoff_s=0.001, own_transport=True)
        store = CheckpointStore(backend=be, host_id="h0")
        store.save_full(0, payload(50))
        for step in range(1, 4):
            store.save_diff(step, payload(50 + step))
        idx = next(i for i, a in enumerate(cio.pack(payload(50))[1])
                   if a.shape == (256,))
        be.flush()
        store.backend.patch("full_00000000", PatchSet().add(
            f"a{idx}", 0, np.full(256, 2.5, np.float32)))
        be.flush()
        want_state, want_diffs = load_latest_chain(store)
        want_state = {k: np.array(v) for k, v in want_state.items()}
        assert be.stats()["acks_total"] == 4
        store.close()
        shutil.rmtree(tmp_path / "a")

        ref_be = jax_peer.PeerReplicaBackend(
            JaxLocal(str(tmp_path / "b")),
            jax_peer.SocketTransport(addr, timeout_s=5.0),
            jax_peer.PeerGroup("h1", "d0",
                               members=[jax_peer.PeerInfo("p1", "d1")]),
            replicas=1, own_transport=True)
        ref = JaxStore(backend=ref_be, host_id="h1")
        assert ref.adopt_peer_manifest() == 4
        state, diffs = jax_load_latest_chain(ref)
        assert tree_equal(state, want_state)
        assert np.all(np.asarray(state["w"]) == 2.5)
        assert [s for s, _ in diffs] == [s for s, _ in want_diffs]
        for (_, got), (_, want) in zip(diffs, want_diffs):
            assert tree_equal(got, want)
        ref.close()
    finally:
        server.close()


def test_port_peer_server_serves_a_reference_host(tmp_path):
    """The other way: a reference host replicates to the port's
    PeerServer, and the port's replacement host recovers bitwise."""
    node = PeerNode("p1", "d1")
    server = PeerServer(node)
    try:
        addr = {"p1": server.address}
        ref_be = jax_peer.PeerReplicaBackend(
            JaxLocal(str(tmp_path / "a")),
            jax_peer.SocketTransport(addr, timeout_s=5.0),
            jax_peer.PeerGroup("h0", "d0",
                               members=[jax_peer.PeerInfo("p1", "d1")]),
            replicas=1, own_transport=True)
        ref = JaxStore(backend=ref_be, host_id="h0")
        ref.save_full(0, payload(60))
        ref.save_diff(1, payload(61))
        ref_be.flush()
        ref.close()
        shutil.rmtree(tmp_path / "a")
        be = PeerReplicaBackend(
            LocalFSBackend(str(tmp_path / "b")),
            SocketTransport(addr, timeout_s=5.0),
            PeerGroup("h1", "d0", members=[PeerInfo("p1", "d1")]),
            replicas=1, own_transport=True)
        store = CheckpointStore(backend=be, host_id="h1")
        assert store.adopt_peer_manifest() == 2
        state, diffs = load_latest_chain(store)
        assert tree_equal(state, payload(60))
        assert [s for s, _ in diffs] == [1]
        assert tree_equal(diffs[0][1], payload(61))
        store.close()
    finally:
        server.close()
