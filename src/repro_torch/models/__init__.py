"""repro_torch.models — the model substrate of the port (PyTorch modules
mirroring the JAX package's ``repro.models``)."""
from .config import ExecConfig, ModelConfig
from .model import Model

__all__ = ["Model", "ModelConfig", "ExecConfig"]
