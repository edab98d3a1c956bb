"""Checkpoint storage: frame codec, manifest journal, local backend and
the chain store (the local-tier subset of ``repro.checkpoint``)."""
from repro_torch.checkpoint.backends import (BACKENDS, LocalFSBackend,  # noqa: F401
                                             make_backend)
from repro_torch.checkpoint.io import FORMATS, FrameCorruptionError  # noqa: F401
from repro_torch.checkpoint.store import CheckpointStore  # noqa: F401
