from repro_torch.core.baselines.centralized import run_centralized
from repro_torch.core.baselines.fedavg import run_fedavg
from repro_torch.core.baselines.fedjets import run_fedjets
from repro_torch.core.baselines.fedkmt import run_fedkmt
from repro_torch.core.baselines.ofa_kd import run_ofa_kd

__all__ = ["run_centralized", "run_fedavg", "run_fedjets", "run_fedkmt",
           "run_ofa_kd"]
