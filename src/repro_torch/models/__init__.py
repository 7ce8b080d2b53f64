"""repro_torch.models — the model substrate of the port (PyTorch modules
mirroring the JAX package's ``repro.models``): ``Model`` serves,
``TrainModel`` trains."""
from .config import ExecConfig, ExtendedConfig, ModelConfig
from .model import Model, TrainModel

__all__ = ["Model", "TrainModel", "ModelConfig", "ExtendedConfig", "ExecConfig"]
