"""Sharded paths over an in-process mesh of torch devices (port of
:mod:`lsm_tpu.parallel`): the domain decomposition (:mod:`.sharding`), the
halo exchange and the sharded general step (:mod:`.halo`), the sharded
adaptive evolution, dense and narrow-band (:mod:`.evolve`), and the fused
kernels per shard with the shell writer K9 (:mod:`.fused_evolve`). The mesh
and its collectives are :mod:`.spmd`.
"""

from .sharding import make_mesh, domain_spec, shard_field, constrain, unshard, ShardedField
from .halo import HaloField, halo_pad_axis, make_sharded_step
from .evolve import ShardedNarrowBandField, make_sharded_evolve, sharded_band_mask

__all__ = ["make_mesh", "domain_spec", "shard_field", "constrain", "HaloField",
           "halo_pad_axis", "make_sharded_step", "ShardedNarrowBandField",
           "make_sharded_evolve", "sharded_band_mask", "unshard", "ShardedField"]
