"""Distribution: logical-axis sharding (DP/FSDP/TP/EP/SP), pipeline, collectives."""
from .api import ShardingRules, constrain, logical_spec, sharding_context
from .devices import DeviceSlot, local_device_pool
