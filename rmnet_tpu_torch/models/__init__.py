"""Networks of the port (counterparts of rmnet_tpu/models)."""

from rmnet_tpu_torch.models.rmnet import RMNet, RMNetApply, VOSState
from rmnet_tpu_torch.models.tiny_flownet import TinyFlowNet
from rmnet_tpu_torch.models.weights import build_models, from_jax_variables

__all__ = ["RMNet", "RMNetApply", "VOSState", "TinyFlowNet", "build_models",
           "from_jax_variables"]
