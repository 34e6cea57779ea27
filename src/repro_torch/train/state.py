"""TrainState: the model (its parameters), the AdamW state and the step,
after ``repro/train/state.py``."""
from __future__ import annotations

from dataclasses import dataclass

from ..models.params import GCLM, params_from_numpy
from ..optim.optim import adamw_init

__all__ = ["TrainState", "init_train_state"]


@dataclass
class TrainState:
    params: GCLM      # parameters, leaves in the reference's order
    opt: dict         # {"m": [...], "v": [...], "count": int}, leaf order
    step: int


def init_train_state(cfg, *, device="cuda", seed: int = 0,
                     params=None) -> TrainState:
    """Fresh state: parameters from ``seed`` on ``device``, or copied from
    ``params`` (a reference parameter tree of numpy arrays) when given."""
    model = GCLM(cfg, device=device, seed=seed)
    if params is not None:
        params_from_numpy(model, params)
    return TrainState(params=model, opt=adamw_init(model.leaves()), step=0)
