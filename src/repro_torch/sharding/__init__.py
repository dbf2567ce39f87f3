"""Sharding rules of the port (``repro_torch.sharding.rules``)."""
from repro_torch.sharding.rules import (abstract_mesh, as_abstract,
                                        batch_spec, block, cache_specs,
                                        data_axes_of, fleet_specs,
                                        host_lanes, opt_state_specs,
                                        paged_cache_specs, param_specs)

__all__ = ["abstract_mesh", "as_abstract", "batch_spec", "block",
           "cache_specs", "data_axes_of", "fleet_specs", "host_lanes",
           "opt_state_specs", "paged_cache_specs", "param_specs"]
