"""Sharding rules and collectives (counterpart of ``repro.distributed``)."""
from repro_torch.distributed import sharding, collectives
