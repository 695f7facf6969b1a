"""Train state: parameters and the AdamW moments and step, with the
sharding of each (:func:`state_specs`)."""

from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def init_state(params) -> TrainState:
    return TrainState(params, adamw.init(params))


def state_specs(params_specs) -> TrainState:
    """The moments take the parameters' specs; the step is replicated (the
    spec of a 0-d leaf, ``()``), as the reference's ``PartitionSpec()``."""
    return TrainState(params_specs,
                      adamw.AdamWState((), params_specs, params_specs))
