"""Peer-memory replication tier, Checkmate-style (port of
``repro.checkpoint.peer``: the same wire protocol, byte for byte).

The paper's differentials are already wire-format blobs, which is the
precondition Checkmate exploits for per-iteration checkpointing with
~zero overhead: instead of persisting every differential to storage,
replicate it into the *memory of K peer hosts* over the network. A
single-host failure then recovers the newest chain from a surviving
peer at network speed; the durable tiers (local NVMe / object store)
only matter for correlated failures. This module is the hot end of the
TierCheck-style placement hierarchy::

    peer memory  ->  CPU-RAM tier  ->  local NVMe / sharded  ->  remote

Pieces:

* wire protocol — framed messages (magic + fixed header + sha256
  trailer) carrying PUT / PATCH / DEL / GET / HAS / CATALOG and
  manifest-record traffic between hosts.
* :class:`PeerNode` — the receiving side: an in-memory replica map plus
  a per-source manifest-record log, with ``kill()`` / ``revive()`` to
  simulate host death in tests and benchmarks.
* :class:`Transport` — how requests reach a node.
  :class:`LoopbackTransport` routes through an in-process
  :class:`PeerHub` (still encoding/decoding the wire format, so the
  framing and checksums are exercised); :class:`SocketTransport` +
  :class:`PeerServer` speak the same protocol over real TCP sockets.
  Both accept a :class:`~repro_torch.checkpoint.remote.FaultInjector` to
  drop or corrupt messages deterministically.
* :class:`PeerReplicaBackend` — a :class:`StorageBackend` that wraps a
  lower tier: every ``put``/``patch``/``delete`` lands locally first
  and is then replicated *asynchronously* to K failure-domain-diverse
  peers through a bounded in-flight window with per-send exp-backoff
  retries and ack tracking. ``get`` falls back to pulling from peers
  when the local blob is gone — which is exactly what recovery on a
  replacement host does. Because it is just a backend, the chain /
  manifest machinery in :class:`~repro_torch.checkpoint.
  store.CheckpointStore` is reused unchanged; the store additionally
  forwards every manifest-journal append through
  ``on_journal_append`` so a replacement host can adopt the dead
  host's manifest from its peers (``CheckpointStore.
  adopt_peer_manifest``).

Replication is *best-effort* by design: a peer that stays unreachable
after bounded retries costs a counter bump, never a training stall —
durability is the lower tier's job, peers buy recovery speed.

Ownership. The port's snapshot leaves are views of pinned host blocks
that the caching allocator hands to the next snapshot, so a replica
taken by reference would later serve another step's bytes. Every
``put`` and ``patch`` therefore copies what it replicates once, into
read-only arrays that the K peers share (and that the framed path
encodes); a peer serves reads of such a replica by reference, since
nothing can write to it.
"""
from __future__ import annotations

import abc
import dataclasses
import hashlib
import json
import socket
import struct
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import io as cio
from repro_torch.checkpoint.backends import StorageBackend, _patchset
from repro_torch.checkpoint.patchset import PatchSet
from repro_torch.checkpoint.remote import (ChecksumError, FaultInjector,
                                           RetryExhaustedError,
                                           TransientStoreError)

__all__ = ["LoopbackTransport", "PeerGroup", "PeerHub", "PeerInfo",
           "PeerNode", "PeerProtocolError", "PeerReplicaBackend",
           "PeerServer", "PeerUnreachableError", "SocketTransport",
           "Transport", "decode_message", "encode_message", "get_hub",
           "reset_hub"]


class PeerProtocolError(Exception):
    """Malformed or unexpected peer message (not retried)."""


class PeerUnreachableError(TransientStoreError):
    """The peer did not answer (dead host, refused connection, timeout).
    Subclasses TransientStoreError: retried with backoff like any other
    transient infrastructure fault."""


# ----------------------------------------------------------------------
# wire protocol
# ----------------------------------------------------------------------

MSG_MAGIC = b"RPEER01\n"
#: magic(8) + kind(4) + key_len(u32) + meta_len(u32) + payload_len(u64)
_HDR = struct.Struct(">8s4sIIQ")
_DIGEST_LEN = 32

# request kinds
PUT, PATCH, DEL, GET, HAS = b"PUT_", b"PTCH", b"DEL_", b"GET_", b"HAS_"
CATALOG, MREC, MGET = b"CTLG", b"MREC", b"MGET"
# response kinds
ACK, DATA, MISS, ERR = b"ACK_", b"DATA", b"MISS", b"ERR_"


def encode_message(kind: bytes, key: str, meta: Optional[dict],
                   payload: bytes = b"") -> bytes:
    """One framed message: fixed header, key, JSON meta, raw payload,
    then a sha256 trailer over everything before it — a flipped byte
    anywhere in flight surfaces as :class:`ChecksumError` on decode,
    never as silently corrupt replica bytes."""
    kb = key.encode("utf-8")
    mb = json.dumps(meta or {}).encode("utf-8")
    head = _HDR.pack(MSG_MAGIC, kind, len(kb), len(mb), len(payload))
    h = hashlib.sha256()
    for part in (head, kb, mb, payload):
        h.update(part)
    return b"".join((head, kb, mb, payload, h.digest()))


def decode_message(buf: bytes) -> Tuple[bytes, str, dict, bytes]:
    """Inverse of :func:`encode_message`. Raises
    :class:`PeerProtocolError` on framing damage and
    :class:`ChecksumError` on a digest mismatch (transient: the sender
    retries)."""
    if len(buf) < _HDR.size + _DIGEST_LEN:
        raise PeerProtocolError(f"short peer message ({len(buf)} bytes)")
    magic, kind, klen, mlen, plen = _HDR.unpack_from(buf)
    if magic != MSG_MAGIC:
        raise PeerProtocolError(f"bad peer magic {magic!r}")
    end = _HDR.size + klen + mlen + plen
    if len(buf) != end + _DIGEST_LEN:
        raise PeerProtocolError(
            f"peer message length mismatch ({len(buf)} != "
            f"{end + _DIGEST_LEN})")
    digest = hashlib.sha256(buf[:end]).digest()
    if digest != buf[end:]:
        raise ChecksumError("peer message sha256 mismatch")
    pos = _HDR.size
    key = buf[pos:pos + klen].decode("utf-8")
    pos += klen
    meta = json.loads(buf[pos:pos + mlen].decode("utf-8"))
    pos += mlen
    return kind, key, meta, buf[pos:pos + plen]


# ----------------------------------------------------------------------
# the receiving side
# ----------------------------------------------------------------------

def _blob_nbytes(meta: dict, blob: Any) -> int:
    """Replica size: wire length for framed blobs, the sender-declared
    (or pack-summed) array bytes for zero-copy object trees."""
    if isinstance(blob, (bytes, bytearray, memoryview)):
        return len(blob)
    n = meta.get("nbytes")
    if n:
        return int(n)
    _, arrays = cio.pack(blob)
    return int(sum(np.asarray(a).nbytes for a in arrays))


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


def owned_copy(obj: Any) -> Any:
    """One private copy of a tree whose arrays are read-only: what the
    peers of one put share. bf16 leaves are rebuilt as fresh tensors by
    ``unpack`` itself."""
    struct, arrays = cio.pack(obj)
    return cio.unpack(struct, [_frozen(np.array(a)) for a in arrays])


def _served(tree: Any) -> Any:
    """A replica tree as a reader gets it by reference: the read-only
    arrays shared, bf16 leaves rebuilt (``unpack`` copies them), so no
    reader can change what the peer holds."""
    return cio.unpack(*cio.pack(tree))


class PeerNode:
    """One host's replica memory: key -> (meta, frame bytes), plus a
    per-source manifest-record log so a replacement host can adopt a
    dead host's manifest. ``kill()`` simulates host death (requests
    raise :class:`PeerUnreachableError`); ``revive()`` brings the host
    back with its memory intact (a process pause, not a reboot — tests
    use kill-without-revive for real loss)."""

    def __init__(self, node_id: str, domain: str = "d0"):
        self.node_id = node_id
        self.domain = domain
        self.alive = True
        self._lock = threading.Lock()
        self._blobs: Dict[str, Tuple[dict, bytes]] = {}
        #: src host id -> {rseq: manifest record}
        self._records: Dict[str, Dict[int, dict]] = {}
        self.puts = 0
        self.gets = 0
        self.patches = 0
        self.deletes = 0

    # -- lifecycle -----------------------------------------------------
    def kill(self) -> None:
        self.alive = False

    def revive(self) -> None:
        self.alive = True

    # -- request dispatch ---------------------------------------------
    def handle(self, kind: bytes, key: str, meta: dict,
               payload: bytes) -> Tuple[bytes, str, dict, bytes]:
        if not self.alive:
            raise PeerUnreachableError(f"peer {self.node_id} is down")
        if kind == PUT:
            with self._lock:
                self._blobs[key] = (dict(meta), payload)
                self.puts += 1
            return ACK, key, {"node": self.node_id,
                              "nbytes": _blob_nbytes(meta, payload)}, b""
        if kind == PATCH:
            return self._patch(key, meta, payload)
        if kind == DEL:
            with self._lock:
                existed = self._blobs.pop(key, None) is not None
                self.deletes += 1
            return ACK, key, {"node": self.node_id, "existed": existed}, b""
        if kind == GET:
            with self._lock:
                hit = self._blobs.get(key)
                self.gets += 1
            if hit is None:
                return MISS, key, {"node": self.node_id}, b""
            blob = hit[1]
            if (not isinstance(blob, (bytes, bytearray, memoryview))
                    and not meta.get("zc")):
                # object-tree replica served to a framed client: the
                # frame encode happens here, on the serving peer. A
                # zero-copy client ("zc") takes the tree by reference.
                blob = cio.frame_dumps(blob)
            return DATA, key, dict(hit[0]), blob
        if kind == HAS:
            with self._lock:
                has = key in self._blobs
            return ACK, key, {"node": self.node_id, "has": has}, b""
        if kind == CATALOG:
            return DATA, "", {"node": self.node_id}, json.dumps(
                self.catalog()).encode("utf-8")
        if kind == MREC:
            recs = json.loads(payload.decode("utf-8"))
            src = meta.get("src", "?")
            with self._lock:
                log = self._records.setdefault(src, {})
                for rec in recs:
                    log[int(rec["rseq"])] = rec
            return ACK, key, {"node": self.node_id, "count": len(recs)}, b""
        if kind == MGET:
            return DATA, "", {"node": self.node_id}, json.dumps(
                self.records()).encode("utf-8")
        return ERR, key, {"error": f"unknown request kind {kind!r}"}, b""

    def _patch(self, key: str, meta: dict,
               payload: bytes) -> Tuple[bytes, str, dict, bytes]:
        """Apply an in-place partial update to a replica: the payload is
        a :class:`PatchSet` wire tree (or a legacy ``{leaf_name: array}``
        dict/frame) keyed by the base frame's payload names (``a0..aN``,
        pack order) — the same addressing the durable tiers' ``patch``
        uses, so peer replicas track range patches and the background
        fold and stay current."""
        updates = (payload if isinstance(payload, dict)
                   else cio.frame_loads(payload))
        if PatchSet.is_tree(updates):
            ps = PatchSet.from_tree(updates)
        else:                    # legacy {leaf_name: array}: whole leaves
            ps = PatchSet()
            for name, arr in updates.items():
                ps.add(name, 0, np.asarray(arr))
        with self._lock:
            hit = self._blobs.get(key)
        if hit is None:
            return MISS, key, {"node": self.node_id}, b""
        old_meta, blob = hit
        as_bytes = isinstance(blob, (bytes, bytearray, memoryview))
        obj = cio.frame_loads(blob) if as_bytes else blob
        tree, arrays = cio.pack(obj)
        for name in ps:
            idx = int(name[1:])  # frame payload names are a<pack index>
            if idx >= len(arrays):
                return ERR, key, {"error": f"patch leaf {name} out of "
                                           f"range for {key}"}, b""
            base = np.asarray(arrays[idx])
            copied = False
            for sp in ps[name]:
                a = np.asarray(sp.data)
                if sp.start == 0 and a.shape == base.shape:
                    base = a     # whole-leaf span: replace by reference
                    continue
                if (base.ndim == 0 or a.ndim == 0 or a.dtype != base.dtype
                        or a.shape[1:] != base.shape[1:]
                        or sp.stop > base.shape[0]):
                    return ERR, key, {
                        "error": f"patch span rows [{sp.start}, {sp.stop}) "
                                 f"of leaf {name} do not fit {key}"}, b""
                if not copied:
                    # replica arrays may be read-only views into the
                    # stored blob — splice into a private copy
                    base = np.array(base)
                    copied = True
                base[sp.start:sp.stop] = a
            if not as_bytes and copied:
                _frozen(base)    # a zero-copy replica stays read-only
            arrays[idx] = base
        new_obj = cio.unpack(tree, arrays)
        # a zero-copy replica stays an object tree; a framed one stays
        # bytes — the representation the replica arrived in is kept
        new_blob = cio.frame_dumps(new_obj) if as_bytes else new_obj
        new_meta = dict(old_meta)
        for k in ("state_step",):
            if k in meta:
                new_meta[k] = meta[k]
        with self._lock:
            # only commit if the replica wasn't deleted/replaced while
            # we were re-serializing outside the lock
            if self._blobs.get(key) is hit:
                self._blobs[key] = (new_meta, new_blob)
            self.patches += 1
        return ACK, key, {"node": self.node_id,
                          "nbytes": _blob_nbytes(new_meta, new_blob)}, b""

    # -- introspection -------------------------------------------------
    def catalog(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(m) for k, (m, _) in self._blobs.items()}

    def records(self) -> Dict[str, List[dict]]:
        with self._lock:
            return {src: [log[s] for s in sorted(log)]
                    for src, log in self._records.items()}

    def replica_bytes(self) -> int:
        with self._lock:
            return sum(_blob_nbytes(m, b)
                       for m, b in self._blobs.values())

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"node": self.node_id, "domain": self.domain,
                    "alive": self.alive, "replicas": len(self._blobs),
                    "replica_bytes": sum(_blob_nbytes(m, b) for m, b
                                         in self._blobs.values()),
                    "puts": self.puts, "gets": self.gets,
                    "patches": self.patches, "deletes": self.deletes}


# ----------------------------------------------------------------------
# membership
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PeerInfo:
    node_id: str
    domain: str = "d0"


class PeerHub:
    """In-process peer registry: the loopback analogue of a cluster
    membership service. Tests and single-process simulations register
    :class:`PeerNode` instances here; :class:`LoopbackTransport` routes
    requests through it."""

    def __init__(self, name: str = "default"):
        self.name = name
        self._lock = threading.Lock()
        self._nodes: Dict[str, PeerNode] = {}

    def ensure(self, node_id: str, domain: str = "d0") -> PeerNode:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                node = PeerNode(node_id, domain)
                self._nodes[node_id] = node
            return node

    def add(self, node: PeerNode) -> PeerNode:
        with self._lock:
            self._nodes[node.node_id] = node
        return node

    def remove(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def node(self, node_id: str) -> PeerNode:
        with self._lock:
            node = self._nodes.get(node_id)
        if node is None:
            raise PeerUnreachableError(f"no peer {node_id!r} in hub "
                                       f"{self.name!r}")
        return node

    def members(self) -> List[PeerInfo]:
        with self._lock:
            return sorted((PeerInfo(n.node_id, n.domain)
                           for n in self._nodes.values()),
                          key=lambda p: p.node_id)


#: process-global named hubs (mirrors remote.py's fake:// bucket
#: registry) so declarative configs can share one simulated cluster
_HUBS: Dict[str, PeerHub] = {}
_HUBS_LOCK = threading.Lock()


def get_hub(name: str = "default") -> PeerHub:
    with _HUBS_LOCK:
        hub = _HUBS.get(name)
        if hub is None:
            hub = PeerHub(name)
            _HUBS[name] = hub
        return hub


def reset_hub(name: str = "default") -> None:
    """Drop a named hub (test isolation)."""
    with _HUBS_LOCK:
        _HUBS.pop(name, None)


class PeerGroup:
    """This host's view of the replication group: who the peers are and
    which K of them receive replicas. Membership is read live from the
    hub (or a static list), so peers joining after the store was built
    become eligible without a rebuild."""

    def __init__(self, self_id: str, self_domain: str = "d0", *,
                 hub: Optional[PeerHub] = None,
                 members: Optional[List[PeerInfo]] = None):
        if hub is None and members is None:
            raise ValueError("PeerGroup needs a hub or a members list")
        self.self_id = self_id
        self.self_domain = self_domain
        self._hub = hub
        self._members = list(members or [])

    def members(self) -> List[PeerInfo]:
        if self._hub is not None:
            return self._hub.members()
        return list(self._members)

    def peers(self) -> List[PeerInfo]:
        return [p for p in self.members() if p.node_id != self.self_id]

    def select(self, k: int) -> List[str]:
        """K replication targets, failure-domain-diverse: one peer per
        distinct domain first — domains other than our own before
        peers that share it (a rack-level failure taking us out must
        not take every replica with us) — then round-robin across
        domains to fill. Deterministic (sorted by node id) so every
        call and every test sees the same assignment."""
        if k <= 0:
            return []
        by_domain: Dict[str, List[PeerInfo]] = {}
        for p in self.peers():
            by_domain.setdefault(p.domain, []).append(p)
        for group in by_domain.values():
            group.sort(key=lambda p: p.node_id)
        # our own domain last: it fails with us
        domains = sorted(by_domain, key=lambda d: (d == self.self_domain, d))
        out: List[str] = []
        depth = 0
        while len(out) < k:
            progressed = False
            for d in domains:
                group = by_domain[d]
                if depth < len(group):
                    out.append(group[depth].node_id)
                    progressed = True
                    if len(out) >= k:
                        break
            if not progressed:  # fewer peers than k: best effort
                break
            depth += 1
        return out


# ----------------------------------------------------------------------
# transports
# ----------------------------------------------------------------------

class Transport(abc.ABC):
    """How a framed request reaches a peer and its response returns."""

    #: True when PUT/PATCH payloads may be passed as object trees by
    #: reference instead of frame bytes (in-process simulation only)
    zero_copy = False

    @abc.abstractmethod
    def request(self, peer_id: str, kind: bytes, key: str,
                meta: Optional[dict] = None, payload: bytes = b""
                ) -> Tuple[bytes, str, dict, bytes]:
        """Send one request, return the decoded response. Raises
        :class:`PeerUnreachableError` (dead/absent peer, transient) or
        :class:`ChecksumError` (corrupt frame in flight, transient)."""

    def close(self) -> None:
        pass


class LoopbackTransport(Transport):
    """In-process transport through a :class:`PeerHub`. By default
    requests and responses round-trip through :func:`encode_message` /
    :func:`decode_message`, so the framing, checksums, and fault
    injection behave exactly like the socket path — minus the kernel.

    ``zero_copy=True`` hands payloads to the peer node by reference
    instead: no wire encode, copies, or checksums on either side. That
    is the right model for *simulated* peers sharing this process — a
    real peer's RAM and NIC DMA cost the sending host's CPU nothing,
    and on a small machine the framed simulation would charge all of
    that phantom work to the training step. Fault injection (drops)
    still applies; checksum corruption needs the framed path."""

    def __init__(self, hub: PeerHub, *,
                 faults: Optional[FaultInjector] = None,
                 latency_s_per_mb: float = 0.0,
                 zero_copy: bool = False):
        self.hub = hub
        self.faults = faults
        self.latency_s_per_mb = latency_s_per_mb
        self.zero_copy = zero_copy
        self.requests = 0
        self.bytes_sent = 0

    def request(self, peer_id: str, kind: bytes, key: str,
                meta: Optional[dict] = None, payload: bytes = b""
                ) -> Tuple[bytes, str, dict, bytes]:
        node = self.hub.node(peer_id)
        self.requests += 1
        if self.zero_copy:
            meta = dict(meta or {}, zc=True)
            nbytes = (len(payload) if isinstance(payload, (bytes,
                      bytearray, memoryview)) else _blob_nbytes(meta,
                                                                payload))
            self.bytes_sent += nbytes
            if self.faults is not None:
                self.faults.on_put(f"{peer_id}/{key}")
            if self.latency_s_per_mb > 0.0:
                time.sleep(self.latency_s_per_mb * nbytes / 2**20)
            rk, rkey, rmeta, rp = node.handle(kind, key, meta, payload)
            if self.faults is not None and isinstance(rp, bytes):
                rp = self.faults.on_get(f"{peer_id}/{key}", rp)
            return rk, rkey, rmeta, rp
        wire = encode_message(kind, key, meta, payload)
        self.bytes_sent += len(wire)
        if self.faults is not None:
            self.faults.on_put(f"{peer_id}/{key}")
        if self.latency_s_per_mb > 0.0:
            time.sleep(self.latency_s_per_mb * len(wire) / 2**20)
        resp = encode_message(*node.handle(*decode_message(wire)))
        if self.faults is not None:
            resp = self.faults.on_get(f"{peer_id}/{key}", resp)
        return decode_message(resp)


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed connection mid-message")
        buf.extend(chunk)
    return bytes(buf)


_LEN = struct.Struct(">Q")


class PeerServer:
    """TCP server exposing one :class:`PeerNode`: length-prefixed
    framed messages, one response per request, connections held open
    until the client closes. A killed node refuses work by closing the
    connection, which the client sees as unreachable."""

    def __init__(self, node: PeerNode, host: str = "127.0.0.1",
                 port: int = 0):
        self.node = node
        self._sock = socket.create_server((host, port))
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name=f"peer-srv-{node.node_id}",
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                head = _recv_exact(conn, _LEN.size)
                wire = _recv_exact(conn, _LEN.unpack(head)[0])
                try:
                    resp = self.node.handle(*decode_message(wire))
                except PeerUnreachableError:
                    return  # node killed: drop the connection
                except (PeerProtocolError, ChecksumError) as e:
                    resp = (ERR, "", {"error": f"{type(e).__name__}: {e}"},
                            b"")
                out = encode_message(*resp)
                conn.sendall(_LEN.pack(len(out)) + out)
        except (ConnectionError, OSError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        self._thread.join(timeout=2.0)


class SocketTransport(Transport):
    """Real-socket transport: one short-lived TCP connection per
    request (simple and stateless; replication traffic is a few
    messages per training step, not RPC-benchmark QPS). Any socket
    error — refused, reset, timeout — maps to
    :class:`PeerUnreachableError` so the caller's retry/backoff logic
    treats network and dead-host identically."""

    def __init__(self, addresses: Dict[str, Tuple[str, int]], *,
                 timeout_s: float = 5.0,
                 faults: Optional[FaultInjector] = None):
        self.addresses = dict(addresses)
        self.timeout_s = timeout_s
        self.faults = faults
        self.requests = 0
        self.bytes_sent = 0

    def request(self, peer_id: str, kind: bytes, key: str,
                meta: Optional[dict] = None, payload: bytes = b""
                ) -> Tuple[bytes, str, dict, bytes]:
        addr = self.addresses.get(peer_id)
        if addr is None:
            raise PeerUnreachableError(f"no address for peer {peer_id!r}")
        wire = encode_message(kind, key, meta, payload)
        self.requests += 1
        self.bytes_sent += len(wire)
        if self.faults is not None:
            self.faults.on_put(f"{peer_id}/{key}")
        try:
            with socket.create_connection(
                    tuple(addr), timeout=self.timeout_s) as conn:
                conn.sendall(_LEN.pack(len(wire)) + wire)
                head = _recv_exact(conn, _LEN.size)
                resp = _recv_exact(conn, _LEN.unpack(head)[0])
        except (ConnectionError, socket.timeout, OSError) as e:
            raise PeerUnreachableError(
                f"peer {peer_id} at {addr} unreachable: {e}") from e
        if self.faults is not None:
            resp = self.faults.on_get(f"{peer_id}/{key}", resp)
        return decode_message(resp)


# ----------------------------------------------------------------------
# the backend
# ----------------------------------------------------------------------

def _kind_of_key(key: str) -> str:
    for prefix, kind in (("full_", "fulls"), ("diff_", "diffs"),
                         ("batch_", "batches"), ("patch_", "patches")):
        if key.startswith(prefix):
            return kind
    return "other"


def _once(fn):
    """Thread-safe memoized thunk: K replication workers share one
    deferred wire encoding instead of serializing K times."""
    lock = threading.Lock()
    cell: list = []

    def call():
        with lock:
            if not cell:
                cell.append(fn())
            return cell[0]

    return call


class PeerReplicaBackend(StorageBackend):
    """Replicate every blob to K failure-domain-diverse peers' memory,
    asynchronously, on top of a lower (durable-ish) tier.

    Write path: ``put``/``patch``/``delete`` complete against ``lower``
    first — the caller's durability contract is the lower tier's,
    unchanged — then the wire-format bytes are handed to a bounded
    in-flight window (``window`` concurrent sends; acquiring a slot
    blocks, which is the backpressure that keeps a slow peer from
    ballooning memory). Each send retries with exponential backoff on
    transient faults (unreachable peer, checksum flip in flight);
    exhausted retries bump ``replication_failures`` and move on —
    peers buy recovery speed, the lower tier owns durability.

    Read path: ``lower`` first; on a miss the blob is pulled from the
    peers (replication targets first, then any group member) — the
    replacement-host recovery path.

    Ack tracking: per-key set of peers that acknowledged the PUT.
    ``unreplicated_keys()`` is the loss window a host failure at this
    instant would expose.
    """

    name = "peer"

    def __init__(self, lower: StorageBackend, transport: Transport,
                 group: PeerGroup, *, replicas: int = 2, window: int = 8,
                 max_retries: int = 3, backoff_s: float = 0.01,
                 backoff_max_s: float = 0.5,
                 own_transport: bool = False):
        if replicas < 0:
            raise ValueError("replicas must be >= 0")
        self.lower = lower
        self.transport = transport
        self.group = group
        self.replicas = replicas
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.persist_root = lower.persist_root
        self.fmt = lower.fmt
        self.src = group.self_id
        self._own_transport = own_transport
        self._lock = threading.Lock()
        self._window = threading.BoundedSemaphore(max(1, window))
        self._pool = ThreadPoolExecutor(max_workers=max(1, window),
                                        thread_name_prefix="peer-rep")
        self._inflight: set = set()
        self._acks: Dict[str, set] = {}
        self._rseq = 0
        from repro_torch.obs.metrics import InstrumentSet
        self._inst = InstrumentSet("peer")
        #: stats() counter keys (the reference's)
        self.KEYS = ("replicated", "acks_total", "replication_failures",
                     "patch_misses", "peer_reads", "retries",
                     "record_sends")
        for k in self.KEYS:
            self._inst.counter(k)
        self.last_error: Optional[str] = None

    def __getattr__(self, name):
        # legacy attribute surface: self.replicated etc. read counters
        if name != "KEYS" and name in getattr(self, "KEYS", ()):
            return int(self._inst.get(name).value)
        raise AttributeError(name)

    def instruments(self):
        """The backing :class:`~repro_torch.obs.metrics.InstrumentSet`."""
        return self._inst

    def _count(self, attr: str, n: int = 1):
        self._inst.counter(attr).add(n)

    # -- provenance ----------------------------------------------------
    @property
    def provenance(self) -> str:
        """Manifest-entry tier tag: the *lower* tier's provenance — a
        put acked here is exactly as durable as the tier below (peer
        replication adds availability, not durability)."""
        return getattr(self.lower, "provenance", self.lower.name)

    # -- replication machinery ----------------------------------------
    def _targets(self) -> List[str]:
        return self.group.select(self.replicas)

    def _send_with_retries(self, peer_id: str, kind: bytes, key: str,
                           meta: dict, payload: bytes
                           ) -> Tuple[bytes, dict, bytes]:
        delay = self.backoff_s
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            try:
                rk, _, rmeta, rp = self.transport.request(
                    peer_id, kind, key, meta, payload)
                if rk == ERR:
                    raise PeerProtocolError(rmeta.get("error", "peer error"))
                return rk, rmeta, rp
            except TransientStoreError as e:  # incl. unreachable/checksum
                last = e
                if attempt < self.max_retries:
                    with self._lock:
                        self._count("retries")
                    time.sleep(delay)
                    delay = min(delay * 2, self.backoff_max_s)
        raise RetryExhaustedError(
            f"peer {peer_id} {kind!r} {key!r} failed after "
            f"{self.max_retries + 1} attempts: {last}")

    def _note_response(self, peer_id: str, kind: bytes, key: str,
                       rk: bytes) -> None:
        with self._lock:
            if kind == PUT and rk == ACK:
                self._acks.setdefault(key, set()).add(peer_id)
                self._count("acks_total")
            elif kind == PATCH and rk == MISS:
                self._count("patch_misses")

    def _note_failure(self, e: Exception) -> None:
        with self._lock:
            self._count("replication_failures")
            self.last_error = repr(e)

    def _replicate_one(self, peer_id: str, kind: bytes, key: str,
                       meta: dict, payload) -> None:
        try:
            if callable(payload):     # deferred wire encoding (see put)
                payload = payload()
            rk, _, _ = self._send_with_retries(peer_id, kind, key, meta,
                                               payload)
        except Exception as e:  # noqa: BLE001 - best-effort by contract
            self._note_failure(e)
            return
        self._note_response(peer_id, kind, key, rk)

    def _send_inline(self, peers: List[str], kind: bytes, key: str,
                     meta: dict, payload) -> List[str]:
        """First-attempt sends on the caller thread (zero-copy
        transports only — the send is a dict insert, cheaper than a
        worker handoff). Peers that fail transiently are returned for
        the async worker, so retry backoff never blocks the step."""
        retry: List[str] = []
        for peer_id in peers:
            try:
                rk, _, rmeta, _ = self.transport.request(
                    peer_id, kind, key, meta, payload)
                if rk == ERR:
                    raise PeerProtocolError(
                        rmeta.get("error", "peer error"))
            except TransientStoreError:
                retry.append(peer_id)
                continue
            except Exception as e:  # noqa: BLE001 - best-effort
                self._note_failure(e)
                continue
            self._note_response(peer_id, kind, key, rk)
        return retry

    def _replicate_fanout(self, peers: List[str], kind: bytes, key: str,
                          meta: dict, payload) -> None:
        from repro_torch.obs.trace import trace_span
        with trace_span("peer.fanout", "peer", key=key,
                        peers=len(peers)):
            if callable(payload):     # deferred wire encoding (see put)
                payload = payload()
            for peer_id in peers:
                self._replicate_one(peer_id, kind, key, meta, payload)

    def _replicate_async(self, kind: bytes, key: str, meta: dict,
                         payload,
                         targets: Optional[List[str]] = None) -> None:
        # one task fans a key out to all K peers: a single dispatch on
        # the step path, K sequential sends on the worker
        peers = self._targets() if targets is None else targets
        if peers and self.transport.zero_copy:
            peers = self._send_inline(peers, kind, key, meta, payload)
        if not peers:
            return
        self._window.acquire()  # bounded in-flight: backpressure
        try:
            fut: Future = self._pool.submit(
                self._replicate_fanout, peers, kind, key, meta, payload)
        except RuntimeError:     # pool shut down mid-close
            self._window.release()
            return
        with self._lock:
            self._inflight.add(fut)

        def _done(f: Future, _self=self) -> None:
            _self._window.release()
            with _self._lock:
                _self._inflight.discard(f)

        fut.add_done_callback(_done)

    # -- StorageBackend ------------------------------------------------
    def put(self, key: str, obj: Any) -> int:
        n = self.lower.put(key, obj)
        if self.replicas > 0:
            meta = {"src": self.src, "kind": _kind_of_key(key),
                    "nbytes": n}
            # the caller may reuse obj's buffers once put returns (the
            # snapshot arena's pinned blocks): copy it once, read-only.
            # A zero-copy transport hands that copy to the K peers by
            # reference; the framed path encodes it on the replication
            # worker, once across the K sends
            owned = owned_copy(obj)
            self._replicate_async(PUT, key, meta,
                                  owned if self.transport.zero_copy
                                  else _once(lambda: cio.frame_dumps(owned)))
            with self._lock:
                self._count("replicated")
        return n

    def get(self, key: str) -> Any:
        try:
            return self.lower.get(key)
        except FileNotFoundError:
            pass
        targets = self._targets()
        candidates = targets + [p.node_id for p in self.group.peers()
                                if p.node_id not in targets]
        for peer_id in candidates:
            try:
                rk, _, rp = self._send_with_retries(peer_id, GET, key,
                                                    {"src": self.src}, b"")
            except (RetryExhaustedError, PeerProtocolError):
                continue
            if rk == DATA:
                with self._lock:
                    self._count("peer_reads")
                if not isinstance(rp, (bytes, bytearray, memoryview)):
                    return _served(rp)   # read-only replica by reference
                return cio.loads_any(rp)
        raise FileNotFoundError(
            f"no blob {key!r} in the lower tier or on "
            f"{len(candidates)} peers")

    def patch(self, key: str, patch: PatchSet) -> int:
        ps = _patchset(patch)
        n = self.lower.patch(key, ps)
        if self.replicas > 0:
            # range PATCH on the wire: the PatchSet's serializable tree,
            # over a read-only copy of the spans (the caller's arrays may
            # change after patch returns); a zero-copy transport takes it
            # by reference, the framed path encodes once across K sends
            tree = ps.copy().to_tree()
            for rows in tree["leaves"].values():
                for a in rows["rows"]:
                    _frozen(a)
            payload = (tree if self.transport.zero_copy
                       else _once(lambda: cio.frame_dumps(tree)))
            self._replicate_async(PATCH, key, {"src": self.src}, payload)
        return n

    def delete(self, key: str) -> None:
        self.lower.delete(key)
        with self._lock:
            self._acks.pop(key, None)
        if self.replicas > 0:
            self._replicate_async(DEL, key, {"src": self.src}, b"")

    def exists(self, key: str) -> bool:
        if self.lower.exists(key):
            return True
        for peer_id in self._targets():
            try:
                rk, rmeta, _ = self._send_with_retries(
                    peer_id, HAS, key, {"src": self.src}, b"")
            except (RetryExhaustedError, PeerProtocolError):
                continue
            if rk == ACK and rmeta.get("has"):
                return True
        return False

    def keys(self) -> List[str]:
        out = set(self.lower.keys())
        out.update(self.peer_catalog())
        return sorted(out)

    def url(self, key: str) -> str:
        return self.lower.url(key)

    def protect(self, keys) -> None:
        self.lower.protect(keys)

    def verify(self, key: str) -> Optional[str]:
        return self.lower.verify(key)

    def sweep_orphans(self, min_age_s: float = 60.0, spare=()) -> int:
        return self.lower.sweep_orphans(min_age_s, spare)

    # -- manifest replication -----------------------------------------
    def on_journal_append(self, op: str, kind: str, *,
                          entry: Optional[dict] = None,
                          key: Optional[str] = None) -> None:
        """Called by the store's journal tap after every local manifest
        append: forward the record (tiny JSON, async, same window) to
        the replication targets so a surviving peer can reconstruct
        this host's manifest after it dies."""
        if self.replicas <= 0:
            return
        with self._lock:
            self._rseq += 1
            rec = {"rseq": self._rseq, "op": op, "kind": kind}
        if entry is not None:
            rec["entry"] = entry
        if key is not None:
            rec["key"] = key
        payload = json.dumps([rec]).encode("utf-8")
        self._replicate_async(MREC, "", {"src": self.src}, payload)
        with self._lock:
            self._count("record_sends")

    def peer_catalog(self) -> Dict[str, dict]:
        """Union of every reachable peer's replica map (key -> meta)."""
        out: Dict[str, dict] = {}
        for peer in self.group.peers():
            try:
                rk, _, rp = self._send_with_retries(
                    peer.node_id, CATALOG, "", {"src": self.src}, b"")
            except (RetryExhaustedError, PeerProtocolError):
                continue
            if rk != DATA:
                continue
            for k, m in json.loads(rp.decode("utf-8")).items():
                out.setdefault(k, m)
        return out

    def peer_manifest(self, src: Optional[str] = None
                      ) -> List[Tuple[str, int, dict]]:
        """Merged manifest records held by the peers, as ordered
        ``(src_host, rseq, record)`` tuples. Records are deduped by
        ``(src, rseq)`` across peers — two peers holding overlapping
        prefixes of the same host's journal merge to one stream. Pass
        ``src`` to restrict to one dead host's records."""
        merged: Dict[Tuple[str, int], dict] = {}
        for peer in self.group.peers():
            try:
                rk, _, rp = self._send_with_retries(
                    peer.node_id, MGET, "", {"src": self.src}, b"")
            except (RetryExhaustedError, PeerProtocolError):
                continue
            if rk != DATA:
                continue
            for rsrc, recs in json.loads(rp.decode("utf-8")).items():
                if src is not None and rsrc != src:
                    continue
                for rec in recs:
                    merged.setdefault((rsrc, int(rec["rseq"])), rec)
        return [(s, q, merged[(s, q)]) for s, q in sorted(merged)]

    def prune_replicas(self, keep_keys) -> int:
        """Delete this host's replicas on every peer for keys no longer
        in the live manifest (folded patches, GC'd chains). Best-effort
        and idempotent — the maintenance service calls it after fold /
        GC completions. Returns replicas removed."""
        keep = set(keep_keys)
        removed = 0
        for peer in self.group.peers():
            try:
                rk, _, rp = self._send_with_retries(
                    peer.node_id, CATALOG, "", {"src": self.src}, b"")
            except (RetryExhaustedError, PeerProtocolError):
                continue
            if rk != DATA:
                continue
            for key, meta in json.loads(rp.decode("utf-8")).items():
                if meta.get("src") != self.src or key in keep:
                    continue
                try:
                    ak, ameta, _ = self._send_with_retries(
                        peer.node_id, DEL, key, {"src": self.src}, b"")
                except (RetryExhaustedError, PeerProtocolError):
                    continue
                if ak == ACK and ameta.get("existed"):
                    removed += 1
        return removed

    # -- ack introspection --------------------------------------------
    def ack_count(self, key: str) -> int:
        with self._lock:
            return len(self._acks.get(key, ()))

    def unreplicated_keys(self, min_acks: int = 1) -> List[str]:
        """Keys whose PUT has fewer than ``min_acks`` peer acks right
        now — the loss window a host death at this instant would leave
        for peers to cover (the durable tier still has them)."""
        with self._lock:
            acked = dict(self._acks)
        live = set(self.lower.keys())
        return sorted(k for k in live
                      if len(acked.get(k, ())) < min_acks)

    # -- lifecycle -----------------------------------------------------
    def flush(self) -> None:
        """Wait for the lower tier's durability AND every in-flight
        replication send (success or counted failure)."""
        while True:
            with self._lock:
                pending = list(self._inflight)
            if not pending:
                break
            for fut in pending:
                try:
                    fut.result(timeout=30.0)
                except Exception:  # noqa: BLE001 - counted in _replicate_one
                    pass
        self.lower.flush()

    def close(self) -> None:
        self.flush()
        self._pool.shutdown(wait=True)
        self.lower.close()
        if self._own_transport:
            self.transport.close()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            acked_keys = sum(1 for s in self._acks.values() if s)
            out = {"backend": self.name, "replicas": self.replicas,
                   "targets": self._targets(),
                   "replicated": self.replicated,
                   "acks_total": self.acks_total,
                   "acked_keys": acked_keys,
                   "replication_failures": self.replication_failures,
                   "patch_misses": self.patch_misses,
                   "peer_reads": self.peer_reads,
                   "retries": self.retries,
                   "record_sends": self.record_sends,
                   "last_error": self.last_error}
        out["lower"] = self.lower.stats()
        return out
