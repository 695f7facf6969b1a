"""Train state: parameters and the AdamW moments and step."""

from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def init_state(params) -> TrainState:
    return TrainState(params, adamw.init(params))
