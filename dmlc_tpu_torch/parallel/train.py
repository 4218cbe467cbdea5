"""The train step on one device.

Counterpart of ``dmlc_tpu/parallel/train.py`` without the mesh: the JAX
package compiles one SPMD program over a dp x tp mesh; here the step
drives one model on one device (a sequence-parallel LM cuts its own
activations over its mesh, ``parallel/sp_transformer.py``), and the dp x tp
step with sharded optimizer state is not ported yet. Works for both
families: BatchNorm CNNs (ResNet, whose running statistics are buffers
of the model) and transformers, and ``lm_train_step`` trains the causal LM.

optax's AdamW and torch's are written differently but are the same algebra
(bias-corrected moments, decoupled weight decay on every parameter, applied
to the parameter before the step). Every hyperparameter is set explicitly:
optax's default decay is 1e-4 on every leaf, torch's is 1e-2.

The entry points (``create_train_state``, and through it ``make_train_step``
and ``TrainingDriver``; ``lm_train_step``) run on the CUDA device unless the
caller passes ``device="cpu"``, and raise without a card
(``utils/device.resolve_device``). A model whose tensors lie elsewhere than
the resolved device is refused.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dmlc_tpu_torch.utils.device import resolve_device

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    """The step counter, the model (its parameters and, for BatchNorm
    models, its running statistics), the optimizer (its moments) and the
    device they live on."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    device: torch.device


def default_optimizer(params: Iterable[torch.Tensor], lr: float = 1e-3,
                      weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=weight_decay)``: betas (0.9, 0.999),
    eps 1e-8, decay on every parameter."""
    return torch.optim.AdamW(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                             weight_decay=weight_decay)


def require_on_device(model: nn.Module, device: torch.device, what: str) -> None:
    """Raise ``ValueError`` unless every parameter and buffer of ``model``
    lies on ``device``."""
    for name, t in (*model.named_parameters(), *model.named_buffers()):
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not on {device}")


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer | None = None, *,
                       device: str | torch.device | None = None) -> TrainState:
    """Step 0 over ``model``, moved to ``device`` (the CUDA device unless
    ``"cpu"`` is named), with ``default_optimizer`` unless one is given. A
    given optimizer must be over ``model``'s parameters and not have
    stepped yet: the move keeps its parameter objects but not its moments."""
    dev = resolve_device(device)
    model.to(dev)
    if optimizer is None:
        optimizer = default_optimizer(model.parameters())
    return TrainState(step=0, model=model, optimizer=optimizer, device=dev)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels, in the logits' dtype
    (``optax.softmax_cross_entropy_with_integer_labels(...).mean()``).
    Leading axes are flattened."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


def make_train_step(state: TrainState, *, remat: bool = False, grad_accum: int = 1
                    ) -> tuple[TrainState, Callable]:
    """Returns ``(state, step_fn)``; ``step_fn(state, images, labels) ->
    (state, {"loss", "accuracy"})`` runs one update in place (the state's
    model and optimizer) and returns the state with its step advanced. The
    metrics are float32 scalar tensors on the model's device.

    ``remat`` recomputes the forward during the backward
    (``torch.utils.checkpoint``) instead of keeping its activations. The
    recomputation would move BatchNorm's running statistics a second
    time, so the buffers as the first forward left them are put back after
    the backward.

    ``grad_accum`` > 1 splits the batch into that many microbatches and
    runs one update on the mean of their gradients. The batch must split
    evenly; BatchNorm statistics move in microbatch order.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    require_on_device(state.model, state.device, "make_train_step")

    def forward(model: nn.Module, images: torch.Tensor, labels: torch.Tensor):
        logits = model(images)
        return cross_entropy(logits, labels), logits

    def micro(model: nn.Module, images: torch.Tensor, labels: torch.Tensor, weight: float):
        if remat:
            loss, logits = checkpoint(forward, model, images, labels, use_reentrant=False)
            saved = [b.clone() for b in model.buffers()]
            (loss * weight).backward()
            with torch.no_grad():
                for b, s in zip(model.buffers(), saved):
                    b.copy_(s)
        else:
            loss, logits = forward(model, images, labels)
            (loss * weight).backward()
        acc = (logits.detach().argmax(dim=-1) == labels).to(torch.float32).mean()
        return loss.detach().to(torch.float32), acc

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        model, opt = state.model, state.optimizer
        images, labels = images.to(state.device), labels.to(state.device)
        model.train()
        opt.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss, acc = micro(model, images, labels, 1.0)
        else:
            if images.shape[0] % grad_accum:
                raise ValueError(
                    f"batch {images.shape[0]} not divisible by "
                    f"grad_accum={grad_accum} x dp=1 (each microbatch "
                    f"must still shard evenly over the dp axis)"
                )
            parts = [micro(model, x, y, 1.0 / grad_accum)
                     for x, y in zip(images.chunk(grad_accum), labels.chunk(grad_accum))]
            loss = torch.stack([p[0] for p in parts]).mean()
            acc = torch.stack([p[1] for p in parts]).mean()
        opt.step()
        state.step += 1
        return state, {"loss": loss, "accuracy": acc}

    return state, step_fn


def lm_loss(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy of a causal LM over ``tokens`` [B, S+1]:
    inputs ``tokens[:, :-1]``, targets ``tokens[:, 1:]``, logits cast to
    float32 first (``bench.py``'s LM train leg)."""
    logits = model(tokens[:, :-1])
    return cross_entropy(logits.to(torch.float32), tokens[:, 1:])


def lm_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
                  *, device: str | torch.device | None = None) -> torch.Tensor:
    """One AdamW update of ``model`` on ``lm_loss``; returns the loss
    before the update (a float32 scalar tensor, not synchronized). The
    model must lie on ``device`` (the CUDA device unless ``"cpu"`` is
    named); ``tokens`` are moved there."""
    dev = resolve_device(device)
    require_on_device(model, dev, "lm_train_step")
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens.to(dev))
    loss.backward()
    optimizer.step()
    return loss.detach()
