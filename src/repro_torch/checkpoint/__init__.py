"""Checkpoint storage: frame and npz codecs, manifest journals (single,
per-host segments, the peer tap), the tier backends (peer, memory,
local, sharded, remote), their declarative configuration and the chain
store (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.backends import (BACKENDS,  # noqa: F401
                                             LocalFSBackend,
                                             MemoryTierBackend,
                                             ShardedBackend, StorageBackend,
                                             make_backend)
from repro_torch.checkpoint.config import (StoreConfig,  # noqa: F401
                                           StoreConfigError, TierSpec)
from repro_torch.checkpoint.io import FORMATS, FrameCorruptionError  # noqa: F401
from repro_torch.checkpoint.journal import (JournalSegment,  # noqa: F401
                                            JournalTap, ManifestJournal,
                                            MemoryJournal,
                                            SegmentedManifestJournal)
from repro_torch.checkpoint.peer import (LoopbackTransport,  # noqa: F401
                                         PeerGroup, PeerHub, PeerInfo,
                                         PeerNode, PeerReplicaBackend,
                                         PeerServer, PeerUnreachableError,
                                         SocketTransport, Transport,
                                         get_hub, reset_hub)
from repro_torch.checkpoint.remote import (ChecksumError,  # noqa: F401
                                           FakeObjectStore, FaultInjector,
                                           FilesystemObjectStore,
                                           ObjectStore, RemoteObjectBackend,
                                           RetryExhaustedError,
                                           TransientStoreError,
                                           make_remote_backend)
from repro_torch.checkpoint.store import (CheckpointStore,  # noqa: F401
                                          order_fulls)
