"""The port's checkpoint format: one pickle of plain types.

A checkpoint is a dict of numpy arrays, dicts, lists, ints, floats and
``scipy.sparse`` matrices; no torch or JAX class is pickled by reference, so
a file written on the card loads on the CPU (and where torch is not
installed).  Its keys:

  * ``format``: ``FORMAT``;
  * ``model``: ``NARModel.state_dict()`` as float32 numpy arrays;
  * ``optimizer``: torch Adam's ``state_dict()``, its tensors as numpy
    arrays (per parameter index: ``step``, ``exp_avg``, ``exp_avg_sq``);
    its ``capturable`` is the writer's device's, and a load keeps the
    live optimizer's;
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
checkpoint.  Under a mesh (``parallel/sharded.py``) the row shards of the
parameters and their Adam moments are gathered into the whole tensors on
save, and each rank keeps its rows on load: a checkpoint written at one
(data x model) layout loads at any other.

The directory backend (``save_train_state_dcp`` / ``load_train_state_dcp``,
the harness's ``save_checkpoint_dcp``) writes the same train state with
``torch.distributed.checkpoint`` (DCP) instead: every rank writes what it
holds, the row shards of a sharded table as a ``DTensor`` over the model
group (so DCP records each shard's row offset and keeps it apart from the
other ranks'), a replicated tensor once.  On load each rank reads the rows
of its live layout, from whatever layout wrote them.  Its keys:
``model.<parameter>``, ``adam.<parameter>.{step,exp_avg,exp_avg_sq}``
(after a first step), ``stream.<field>``, ``generator.<device type>`` and
``step``.
"""
from __future__ import annotations

import contextlib
import shutil
import warnings
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..convert import stream_from_numpy
from ..state.stream_state import StreamState
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


def pack_train_state(state: TrainState, programs=None) -> Dict[str, Any]:
    """The train state's part of a checkpoint payload; under a mesh
    (``programs``, every rank calls it) with the row shards gathered."""
    params = state.model.state_dict()
    optimizer = state.optimizer.state_dict()
    if programs is not None:
        params = programs.full_tensors(params)
        optimizer = dict(optimizer, state=_map_moments(
            state.model, optimizer["state"], programs.full_tensors))
    return {
        "format": FORMAT,
        "model": to_plain(params),
        "optimizer": to_plain(optimizer),
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


def _map_moments(model, optimizer_state: Mapping, fn) -> Dict:
    """Adam's per-parameter state with ``fn`` ({name: tensor} -> {name:
    tensor}) applied to each parameter's moments."""
    names = [name for name, _ in model.named_parameters()]
    return {
        index: dict(fields, **{k: fn({names[index]: fields[k]})[names[index]]
                               for k in ("exp_avg", "exp_avg_sq")})
        for index, fields in optimizer_state.items()
    }


def unpack_train_state(payload: Mapping, state: TrainState, programs=None) -> TrainState:
    """Load a payload into ``state``'s model and optimizer (in place, on
    their device) and return the train state with the payload's stream,
    generator state and step; under a mesh (``programs``) each rank keeps
    its rows of the row-sharded tensors.  torch's CPU and CUDA generators
    are different algorithms, so a generator state saved on the other
    device type is not loaded; the generator is then re-seeded with its
    initial seed, as it is where the payload carries no generator state."""
    _check_format(payload)
    params = model_params(payload)
    # copies: torch's Adam counts its step in place, so no two parameters
    # may share one step tensor
    moments = {
        index: {k: torch.tensor(np.asarray(v)) for k, v in fields.items()}
        for index, fields in payload["optimizer"]["state"].items()
    }
    if programs is not None:
        params = programs.local_tensors(params)
        moments = _map_moments(state.model, moments, programs.local_tensors)
    state.model.load_state_dict(params, strict=True)
    # whether Adam is capturable follows the live device (``init_train_state``),
    # not the one that wrote the file
    state.optimizer.load_state_dict({
        "state": moments,
        "param_groups": [dict(saved, capturable=live["capturable"]) for saved, live in
                         zip(payload["optimizer"]["param_groups"],
                             state.optimizer.param_groups)],
    })
    device = next(state.model.parameters()).device
    saved = payload["generator"]
    if saved is not None and saved["device"] == state.generator.device.type:
        state.generator.set_state(torch.from_numpy(np.asarray(saved["state"])))
    else:
        state.generator.manual_seed(state.generator.initial_seed())
    return state._replace(stream=stream_from_numpy(payload["stream"], device=device),
                          step=int(payload["step"]))


def _dcp_layout(state: TrainState, programs=None):
    """``(wrap, local)``: ``wrap(name, tensor)`` gives DCP the rank's
    ``tensor`` of the parameter ``name`` (or of its Adam moments), the row
    shard of a sharded one as a ``DTensor`` at its global shape;
    ``local(value)`` undoes it."""
    from torch.distributed.tensor import DTensor, Shard

    sharding = {} if programs is None else {
        name: spec for name, spec in programs.state_sharding.items() if spec is not None}
    mesh = None
    if sharding:
        from torch.distributed.device_mesh import DeviceMesh

        mesh = DeviceMesh.from_group(programs.plan.model_group, programs.plan.device.type)

    def wrap(name, tensor):
        spec = sharding.get(name)
        if spec is None or tensor.ndim == 0:
            return tensor
        shape = list(tensor.shape)
        shape[spec.dim] = spec.rows.rows
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(tensor, mesh, [Shard(spec.dim)], run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    def local(value):
        return value.to_local() if isinstance(value, DTensor) else value

    return wrap, local


@contextlib.contextmanager
def _single_process_quiet():
    """DCP warns on every call without a process group that it assumes one
    process, which ``no_dist`` says already."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def save_train_state_dcp(path, state: TrainState, programs=None) -> None:
    """Write ``state`` as a DCP checkpoint directory ``path`` (replacing
    one there); under a mesh (``programs``) every rank calls it and writes
    its own rows of the sharded tables."""
    import torch.distributed.checkpoint as dcp

    path = Path(path)
    if programs is None or programs.plan.rank == 0:
        shutil.rmtree(path, ignore_errors=True)
    if programs is not None:
        from ..parallel.distributed import barrier

        barrier(programs.plan)  # no rank writes before the old files are gone
    wrap, _ = _dcp_layout(state, programs)
    tensors = {f"model.{n}": wrap(n, t) for n, t in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        tensors.update({f"adam.{name}.{k}": wrap(name, v)
                        for k, v in state.optimizer.state.get(p, {}).items()})
    tensors.update({f"stream.{k}": v for k, v in state.stream._asdict().items()})
    tensors[f"generator.{state.generator.device.type}"] = state.generator.get_state()
    tensors["step"] = torch.tensor(int(state.step))
    with _single_process_quiet():
        dcp.save(tensors, checkpoint_id=str(path), no_dist=programs is None)


def load_train_state_dcp(path, state: TrainState, programs=None) -> TrainState:
    """Load the DCP checkpoint directory ``path`` into ``state``'s model
    and optimizer (in place, on their device; each rank its rows of the
    live layout) and return the train state with its stream, generator
    state and step.  A generator state saved on the other device type is
    not loaded: the generator is re-seeded with its initial seed, as
    ``unpack_train_state`` does."""
    import torch.distributed.checkpoint as dcp

    path = str(path)
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    wrap, local = _dcp_layout(state, programs)
    params = state.model.state_dict()
    dest = {f"model.{n}": wrap(n, torch.empty_like(t)) for n, t in params.items()}
    for name, t in params.items():
        key = f"adam.{name}"
        if f"{key}.step" in saved:
            dest[f"{key}.step"] = torch.zeros((), dtype=saved[f"{key}.step"].properties.dtype)
            for k in ("exp_avg", "exp_avg_sq"):
                dest[f"{key}.{k}"] = wrap(name, torch.zeros_like(t))
    dest.update({f"stream.{k}": torch.empty_like(v)
                 for k, v in state.stream._asdict().items()})
    generator = f"generator.{state.generator.device.type}"
    if generator in saved:
        dest[generator] = torch.empty_like(state.generator.get_state())
    dest["step"] = torch.zeros((), dtype=torch.int64)
    with _single_process_quiet():
        dcp.load(dest, checkpoint_id=path, no_dist=programs is None)

    state.model.load_state_dict({n: local(dest[f"model.{n}"]) for n in params}, strict=True)
    names = [name for name, _ in state.model.named_parameters()]
    state.optimizer.load_state_dict({
        "state": {index: {k: local(dest[f"adam.{name}.{k}"])
                          for k in ("step", "exp_avg", "exp_avg_sq")}
                  for index, name in enumerate(names) if f"adam.{name}.step" in dest},
        "param_groups": state.optimizer.state_dict()["param_groups"],
    })
    if generator in dest:
        state.generator.set_state(dest[generator])
    else:
        state.generator.manual_seed(state.generator.initial_seed())
    stream = StreamState(**{k: dest[f"stream.{k}"] for k in StreamState._fields})
    return state._replace(stream=stream, step=int(dest["step"]))


def _check_format(payload: Mapping) -> None:
    if payload.get("format") != FORMAT:
        raise ValueError(
            f"not a checkpoint of this package: format {payload.get('format')!r}, "
            f"expected {FORMAT!r} (convert.checkpoint_from_jax converts a JAX "
            "harness checkpoint)"
        )
