"""Packed scene -> device tensors."""
from softwarerenderer_tpu_torch.models import primitives, scene  # noqa: F401
