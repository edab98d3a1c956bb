"""Checkpoint storage: frame and npz codecs, manifest journals, the tier
backends (local, memory, sharded, remote), their declarative
configuration and the chain store (port of ``repro.checkpoint``; the
peer tier is not ported yet)."""
from repro_torch.checkpoint.backends import (BACKENDS,  # noqa: F401
                                             LocalFSBackend,
                                             MemoryTierBackend,
                                             ShardedBackend, StorageBackend,
                                             make_backend)
from repro_torch.checkpoint.config import (StoreConfig,  # noqa: F401
                                           StoreConfigError, TierSpec)
from repro_torch.checkpoint.io import FORMATS, FrameCorruptionError  # noqa: F401
from repro_torch.checkpoint.journal import (ManifestJournal,  # noqa: F401
                                            MemoryJournal)
from repro_torch.checkpoint.remote import (ChecksumError,  # noqa: F401
                                           FakeObjectStore, FaultInjector,
                                           FilesystemObjectStore,
                                           ObjectStore, RemoteObjectBackend,
                                           RetryExhaustedError,
                                           TransientStoreError,
                                           make_remote_backend)
from repro_torch.checkpoint.store import CheckpointStore  # noqa: F401
