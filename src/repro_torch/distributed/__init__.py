"""Partition-spec machinery, the sharded step builders and their
collectives (port of ``repro.distributed``) on ``torch.distributed``."""
