"""Gradient compression of the train step: the stateless bfloat16 cast
(the int8 scheme with error feedback is ROADMAP queue A item 23)."""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_map


def compress_bf16(grads):
    """Stateless bfloat16 gradient payload."""
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads):
    return tree_map(lambda g: g.to(torch.float32), grads)
