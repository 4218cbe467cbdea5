from dmlc_tpu_torch.models.alexnet import AlexNet, alexnet
from dmlc_tpu_torch.models.registry import ModelSpec, get_model, list_models, register
from dmlc_tpu_torch.models.resnet import ResNet, resnet18, resnet34, resnet50

__all__ = [
    "AlexNet", "alexnet",
    "ModelSpec", "get_model", "list_models", "register",
    "ResNet", "resnet18", "resnet34", "resnet50",
]
