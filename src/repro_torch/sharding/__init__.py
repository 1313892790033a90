"""repro_torch.sharding: the reference's sharding rules and activation
context for the LM on a ``torch.distributed`` device mesh."""

from repro_torch.sharding.rules import (AbstractMesh, PartitionSpec,
                                        ShardingRules, batch_spec,
                                        cache_specs, logits_spec,
                                        make_rules, named, param_specs)

__all__ = ["AbstractMesh", "PartitionSpec", "ShardingRules", "make_rules",
           "param_specs", "cache_specs", "batch_spec", "logits_spec",
           "named"]
