from repro_torch.federated.async_fleet import train_fleet_async
from repro_torch.federated.device import (STRAGGLER_PROFILES, DeviceSpec,
                                          TrafficModel, device_upload_bytes,
                                          sample_traffic, train_device,
                                          train_fleet)
from repro_torch.federated.server import (AsyncFleetConfig, DeepFusionServer,
                                          FleetAggregator, ServerConfig,
                                          staleness_weight)
from repro_torch.federated.simulation import (SimulationConfig, build_fleet,
                                              run_deepfusion)

__all__ = ["DeviceSpec", "TrafficModel", "STRAGGLER_PROFILES",
           "sample_traffic", "train_device", "train_fleet",
           "train_fleet_async", "device_upload_bytes", "DeepFusionServer",
           "ServerConfig", "AsyncFleetConfig", "FleetAggregator",
           "staleness_weight", "SimulationConfig", "build_fleet",
           "run_deepfusion"]
