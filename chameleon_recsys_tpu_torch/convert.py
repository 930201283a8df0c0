"""Weight bridge from the JAX package's Flax parameters and stream state.

``params_from_flax`` takes the Flax param tree of
``chameleon_recsys_tpu.models.nar.NARModel`` as nested dicts of numpy arrays
and returns a ``state_dict`` for this package's ``NARModel``.  Flax ``Dense``
and ``Embed`` layers become ``nn.Linear`` / ``nn.Embedding`` (a Dense kernel
is [in, out], ``nn.Linear.weight`` is [out, in]); the explicit kernels
(PreCAR, CAR, matching, recurrent) keep their [in, out] layout.  A name that
matches no rule raises, and so does a tree that lacks or adds a parameter of
the model it is meant for, so that no weight is silently ignored.

``flax_from_tensors`` goes the other way: a mapping of this package's
parameter names to tensors (parameters, their gradients, updated values)
becomes a Flax-shaped nested dict of numpy arrays, transposed back, so that
a test can hold it leaf by leaf against the JAX package's trees.

``checkpoint_from_jax`` turns a JAX harness checkpoint, given as numpy trees
(unpickling the JAX file needs the JAX package, which this one never
imports), into a checkpoint of this package's format: the params through
``params_from_flax``, optax's Adam state into torch Adam's, the stream
through ``stream_from_numpy``, the host fields as they are.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .state.stream_state import StreamState

# (flax path pattern, torch key template, transpose)
_RULES = (
    (r"(gamma_scale|beta_center|(?:PreCAR|CAR)_(?:kernel|bias))", r"\1", False),
    (r"(matching_(?:\d+|out)_(?:kernel|bias))", r"\1", False),
    (r"item_clicked_embedding/embedding", "item_clicked_embedding.weight", False),
    (r"(article_metadata_towers|user_context_towers)/(\w+_embedding)/embedding",
     r"\1.embeddings.\2.weight", False),
    (r"rnn/layer_(\d+)/input_proj/kernel", r"rnn.layers.\1.input_proj.weight", True),
    (r"rnn/layer_(\d+)/input_proj/bias", r"rnn.layers.\1.input_proj.bias", False),
    (r"rnn/layer_(\d+)/recurrent_kernel", r"rnn.layers.\1.recurrent_kernel", False),
    (r"(session_FC[12])/kernel", r"\1.weight", True),
    (r"(session_FC[12])/bias", r"\1.bias", False),
)


# (torch key pattern, flax path template, transpose): the inverse of _RULES
_INVERSE_RULES = (
    (r"(gamma_scale|beta_center|(?:PreCAR|CAR)_(?:kernel|bias))", r"\1", False),
    (r"(matching_(?:\d+|out)_(?:kernel|bias))", r"\1", False),
    (r"item_clicked_embedding\.weight", "item_clicked_embedding/embedding", False),
    (r"(article_metadata_towers|user_context_towers)\.embeddings\.(\w+_embedding)"
     r"\.weight", r"\1/\2/embedding", False),
    (r"rnn\.layers\.(\d+)\.input_proj\.weight", r"rnn/layer_\1/input_proj/kernel", True),
    (r"rnn\.layers\.(\d+)\.input_proj\.bias", r"rnn/layer_\1/input_proj/bias", False),
    (r"rnn\.layers\.(\d+)\.recurrent_kernel", r"rnn/layer_\1/recurrent_kernel", False),
    (r"(session_FC[12])\.weight", r"\1/kernel", True),
    (r"(session_FC[12])\.bias", r"\1/bias", False),
)


def _flax_path(key: str) -> Tuple[str, bool]:
    """This package's parameter name -> (the Flax path, '/'-joined, and
    whether the array is transposed between the two)."""
    for pattern, template, transpose in _INVERSE_RULES:
        match = re.fullmatch(pattern, key)
        if match:
            return match.expand(template), transpose
    raise KeyError(f"no rule maps the parameter {key!r} to a Flax path")


def flax_from_tensors(tensors: Mapping[str, torch.Tensor]) -> Dict:
    """{parameter name: tensor} -> nested dict of float32 numpy arrays in the
    Flax tree's layout (e.g. ``{n: p.grad for n, p in
    model.named_parameters()}`` against ``jax.grad``'s tree)."""
    tree: Dict = {}
    for key, tensor in tensors.items():
        path, transpose = _flax_path(key)
        array = tensor.detach().to("cpu", torch.float32).numpy()
        node = tree
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(array.T if transpose else array)
    return tree


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def params_from_flax(tree: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Flax NAR params (nested dicts of arrays) -> ``state_dict`` for
    ``model``.  The result must hold exactly the model's parameters, in their
    shapes: a Flax parameter the model does not consume, a model parameter
    the tree lacks, or a shape that differs raises."""
    state = {}
    for path, value in _flatten(tree).items():
        for pattern, template, transpose in _RULES:
            match = re.fullmatch(pattern, path)
            if match:
                break
        else:
            raise KeyError(f"no rule maps the Flax parameter {path!r}")
        key = match.expand(template)
        array = value.T if transpose else value
        state[key] = torch.from_numpy(np.ascontiguousarray(array, np.float32))
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    unused = sorted(set(state) - set(expected))
    if missing or unused:
        raise KeyError(
            f"Flax tree does not match the model: missing {missing}, "
            f"not consumed {unused}"
        )
    for key, tensor in state.items():
        if tuple(tensor.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"{key}: Flax shape {tuple(tensor.shape)} != model shape "
                f"{tuple(expected[key].shape)}"
            )
    return state


_STREAM_DTYPES = {
    "buffer_ids": torch.int32,
    "buffer_ts": torch.int32,
    "recent_pop": torch.int32,
    "recent_pop_norm": torch.float32,
    "global_pop": torch.int32,
    "current_step": torch.int32,
}


def stream_from_numpy(fields: Mapping, device="cuda") -> StreamState:
    """``StreamState`` from a mapping of its field names to arrays (e.g. the
    JAX ``StreamState._asdict()`` after ``np.asarray``)."""
    if set(fields) != set(_STREAM_DTYPES):
        raise KeyError(
            f"stream fields {sorted(fields)} != {sorted(_STREAM_DTYPES)}"
        )
    return StreamState(**{
        name: torch.tensor(np.asarray(fields[name]), dtype=dtype, device=device)
        for name, dtype in _STREAM_DTYPES.items()
    })


_HOST_FIELDS = ("hours_trained", "evals_done", "metrics_log", "host_cooccurrence",
                "host_first_click_step", "host_current_step",
                "host_benchmarks_states")


def adam_state_from_optax(count, mu: Mapping, nu: Mapping, model: nn.Module) -> Dict:
    """optax's ``ScaleByAdamState`` (``count`` and the Flax-shaped moment
    trees ``mu``, ``nu``) -> the ``state`` of torch Adam over
    ``model.parameters()``: per parameter index ``step`` = count (optax
    counts the updates taken, as torch's ``step``), ``exp_avg`` = mu and
    ``exp_avg_sq`` = nu, laid out as ``params_from_flax`` lays the params."""
    exp_avg = params_from_flax(mu, model)
    exp_avg_sq = params_from_flax(nu, model)
    return {
        index: {"step": np.array(count, np.float32).reshape(()),
                "exp_avg": exp_avg[name].numpy(),
                "exp_avg_sq": exp_avg_sq[name].numpy()}
        for index, (name, _) in enumerate(model.named_parameters())
    }


def checkpoint_from_jax(jax_checkpoint: Mapping[str, Any],
                        model: nn.Module) -> Dict[str, Any]:
    """A JAX harness checkpoint (``chameleon_recsys_tpu/train/temporal.py``,
    ``save_checkpoint``) as numpy trees -> a checkpoint of this package's
    format (``train/checkpoint.py``).  ``jax_checkpoint`` holds

      * ``params``: the Flax param tree;
      * ``adam``: ``{"count", "mu", "nu"}``, optax's ``ScaleByAdamState``;
      * ``stream``: the ``StreamState`` fields; ``step``: the state's step;
      * the JAX payload's host fields (``hours_trained``, ``evals_done``,
        ``metrics_log``, ``host_*``), passed through as they are.

    ``model`` is a ``NARModel`` of the checkpoint's configuration (Adam's
    hyperparameters come from its ``cfg``, as ``init_train_state`` sets
    them).  JAX's random key has no torch counterpart: the checkpoint
    carries no generator state, and the loading harness keeps its own
    generator, seeded from ``run_cfg.random_seed``."""
    from .train.checkpoint import FORMAT
    from .train.steps import init_train_state

    adam = jax_checkpoint["adam"]
    optimizer = init_train_state(model, None, None).optimizer
    payload = {
        "format": FORMAT,
        "model": {k: v.numpy() for k, v in
                  params_from_flax(jax_checkpoint["params"], model).items()},
        "optimizer": {
            "state": adam_state_from_optax(adam["count"], adam["mu"], adam["nu"],
                                           model),
            "param_groups": optimizer.state_dict()["param_groups"],
        },
        "stream": {k: np.asarray(v) for k, v in jax_checkpoint["stream"].items()},
        "generator": None,
        "step": int(jax_checkpoint["step"]),
    }
    payload.update({k: jax_checkpoint[k] for k in _HOST_FIELDS})
    return payload
