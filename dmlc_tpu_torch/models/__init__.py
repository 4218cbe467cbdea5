from dmlc_tpu_torch.models.alexnet import AlexNet, alexnet
from dmlc_tpu_torch.models.clip import CLIPVisionEncoder, clip_vit_b32, clip_vit_l14
from dmlc_tpu_torch.models.registry import ModelSpec, get_model, list_models, register
from dmlc_tpu_torch.models.resnet import ResNet, resnet18, resnet34, resnet50
from dmlc_tpu_torch.models.vit import ViT, vit_b16, vit_l14

__all__ = [
    "AlexNet", "alexnet",
    "CLIPVisionEncoder", "clip_vit_b32", "clip_vit_l14",
    "ModelSpec", "get_model", "list_models", "register",
    "ResNet", "resnet18", "resnet34", "resnet50",
    "ViT", "vit_b16", "vit_l14",
]
