"""The port's checkpoint format: one pickle of plain types.

A checkpoint is a dict of numpy arrays, dicts, lists, ints, floats and
``scipy.sparse`` matrices; no torch or JAX class is pickled by reference, so
a file written on the card loads on the CPU (and where torch is not
installed).  Its keys:

  * ``format``: ``FORMAT``;
  * ``model``: ``NARModel.state_dict()`` as float32 numpy arrays;
  * ``optimizer``: torch Adam's ``state_dict()``, its tensors as numpy
    arrays (per parameter index: ``step``, ``exp_avg``, ``exp_avg_sq``);
  * ``stream``: the ``StreamState`` fields;
  * ``generator``: ``{"device": "cpu" | "cuda", "state": uint8 array}``, the
    train state's ``torch.Generator``, or ``None`` where the checkpoint has
    none (one converted from JAX);
  * ``step``: the train state's step count;
  * the harness's fields: ``hours_trained``, ``evals_done``,
    ``metrics_log`` and ``host_cooccurrence``, ``host_first_click_step``,
    ``host_current_step``, ``host_benchmarks_states`` (as the JAX
    harness names them).

``convert.checkpoint_from_jax`` writes the same format from a JAX harness
checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..convert import stream_from_numpy
from .steps import TrainState

FORMAT = "chameleon_recsys_tpu_torch/checkpoint-1"


def to_plain(value: Any) -> Any:
    """Tensors (at any depth of dicts, lists and tuples) -> numpy arrays on
    the host; everything else as it is."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, Mapping):
        return {k: to_plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_plain(v) for v in value)
    return value


def pack_train_state(state: TrainState) -> Dict[str, Any]:
    """The train state's part of a checkpoint payload."""
    return {
        "format": FORMAT,
        "model": to_plain(state.model.state_dict()),
        "optimizer": to_plain(state.optimizer.state_dict()),
        "stream": to_plain(state.stream._asdict()),
        "generator": {
            "device": state.generator.device.type,
            "state": state.generator.get_state().numpy(),
        },
        "step": int(state.step),
    }


def model_params(payload: Mapping) -> Dict[str, torch.Tensor]:
    """The payload's model parameters as a ``state_dict`` on the host."""
    _check_format(payload)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in payload["model"].items()}


def unpack_train_state(payload: Mapping, state: TrainState) -> TrainState:
    """Load a payload into ``state``'s model and optimizer (in place, on
    their device) and return the train state with the payload's stream,
    generator state and step.  torch's CPU and CUDA generators are
    different algorithms, so a generator state saved on the other device
    type is not loaded; the generator is then re-seeded with its initial
    seed, as it is where the payload carries no generator state."""
    _check_format(payload)
    state.model.load_state_dict(model_params(payload), strict=True)
    optimizer = payload["optimizer"]
    # copies: torch's Adam counts its step in place, so no two parameters
    # may share one step tensor
    state.optimizer.load_state_dict({
        "state": {
            index: {k: torch.tensor(np.asarray(v)) for k, v in fields.items()}
            for index, fields in optimizer["state"].items()
        },
        "param_groups": optimizer["param_groups"],
    })
    device = next(state.model.parameters()).device
    saved = payload["generator"]
    if saved is not None and saved["device"] == state.generator.device.type:
        state.generator.set_state(torch.from_numpy(np.asarray(saved["state"])))
    else:
        state.generator.manual_seed(state.generator.initial_seed())
    return state._replace(stream=stream_from_numpy(payload["stream"], device=device),
                          step=int(payload["step"]))


def _check_format(payload: Mapping) -> None:
    if payload.get("format") != FORMAT:
        raise ValueError(
            f"not a checkpoint of this package: format {payload.get('format')!r}, "
            f"expected {FORMAT!r} (convert.checkpoint_from_jax converts a JAX "
            "harness checkpoint)"
        )
