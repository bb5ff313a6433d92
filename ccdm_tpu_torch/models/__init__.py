from ccdm_tpu_torch.models.builder import DenoisingModel, build_model
from ccdm_tpu_torch.models.unet import UNetModel, create_unet

__all__ = ["UNetModel", "create_unet", "DenoisingModel", "build_model"]
