"""Differentiable rendering: gradients of an image loss with respect to
material parameters (colors, emission, triangle colors, textures)."""
from .checkpoint import restore_train_state, save_train_state
from .grad import (
    SceneParams, apply_params, extract_params, render_image_diff,
    image_loss, train_step, make_sharded_train_step,
)

__all__ = [
    "SceneParams", "apply_params", "extract_params", "render_image_diff",
    "image_loss", "train_step", "make_sharded_train_step",
    "save_train_state", "restore_train_state",
]
