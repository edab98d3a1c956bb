"""Checkpoint maintenance service (port of ``repro.maintenance``):
crash-resumable background GC, integrity scrubbing, journal-segment
merging, the patch-chain fold and peer-replica pruning.

Usage::

    store = StoreConfig(root, retention_fulls=2).build()
    svc = MaintenanceService(store, gc_slice=64, scrub_interval=30.0)
    store.attach_maintenance(svc)
    svc.start()                 # resumes any crashed task first
    ...                         # save_full() now schedules GC async
    store.flush()               # drains pending maintenance slices
    store.close()               # stops the service
"""
from __future__ import annotations

from repro_torch.maintenance.progress import MemoryProgress, ProgressJournal
from repro_torch.maintenance.service import InjectedCrash, MaintenanceService

__all__ = ["InjectedCrash", "MaintenanceService", "MemoryProgress",
           "ProgressJournal"]
