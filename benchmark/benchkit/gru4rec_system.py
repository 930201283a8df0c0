"""GRU4Rec under test, ``chameleon_recsys_tpu_torch``'s neural-baseline path,
built from a configuration's ``gru4rec`` block as ``cli/run_gru4rec.py``
builds it from its flags: ``GRU4Rec`` and the ``NeuralBaselineRunner``
that drives ``fit_batch`` over an hour's sessions, with the CLI's
``NARConfig`` and minimal session schema.  The weights are the benchmark's;
the click buffer is warmed with the benchmark's history.  Beside
``system.py``, the only module of the benchmark that imports the system."""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from chameleon_recsys_tpu_torch.baselines import gru4rec
from chameleon_recsys_tpu_torch.baselines.neural_runner import NeuralBaselineRunner
from chameleon_recsys_tpu_torch.cli.run_gru4rec import minimal_session_schema
from chameleon_recsys_tpu_torch.config import NARConfig
from chameleon_recsys_tpu_torch.data.collate import batches_from_sessions


def make_runner(config: dict, weights: Mapping[str, torch.Tensor], sampler_seed: int,
                device) -> NeuralBaselineRunner:
    """The CLI's model and runner on ``device`` holding ``weights``; the
    sampler's generator seeded from ``sampler_seed``."""
    g = config["gru4rec"]
    model = gru4rec.GRU4Rec(
        int(g["n_items"]), layers=tuple(int(u) for u in g["layers"]), loss=g["loss"],
        bpreg=float(g["bpreg"]), learning_rate=float(g["learning_rate"]),
        n_sample=int(g["n_sample"]), dropout_p_hidden=float(g["dropout_p_hidden"]),
        optimizer=g["optimizer"], decay=float(g["optimizer_decay"]),
        momentum=float(g["momentum"]), lmbd=float(g["l2_lambda"]),
        seed=int(sampler_seed) % (2 ** 31), neg_pool_capacity=int(g["neg_pool_capacity"]),
        device=device)
    own = {n: tuple(p.shape) for n, p in model.params.state_dict().items()}
    given = {n: tuple(p.shape) for n, p in weights.items()}
    if own != given:
        raise RuntimeError(f"the model's parameters differ from the configuration's: "
                           f"{sorted(set(own.items()) ^ set(given.items()))[:6]}")
    model.params.load_state_dict(weights, strict=True)
    model.generator.manual_seed(int(sampler_seed) % (2 ** 63))
    cfg = NARConfig(batch_size=int(g["batch_size"]),
                    max_session_length=int(g["truncate_session_length"]),
                    recent_clicks_buffer_max_size=int(g["recent_clicks_buffer_max_size"]),
                    recent_clicks_buffer_hours=float(g["recent_clicks_buffer_hours"]),
                    metrics_top_n=int(g["eval_metrics_top_n"]),
                    eval_negative_samples=int(g["eval_total_negative_samples"]))
    n = int(g["n_items"])
    return NeuralBaselineRunner(model, cfg, minimal_session_schema(n), n, lambda: [])


def warm_buffer(runner: NeuralBaselineRunner, sessions) -> None:
    """The runner's click buffer after the history hour's batches."""
    for batch in batches_from_sessions(sessions, runner.schema, runner.cfg.batch_size,
                                       runner.cfg.max_session_length):
        runner._update_buffer(batch)


def record_steps(runner: NeuralBaselineRunner, records: List[dict]):
    """Record each step's inputs, labels, negatives and scores, as the timed
    path computes them; returns a function that stops recording."""
    model = runner.model
    loss_fn = gru4rec.LOSSES[model.loss_name]
    step: Dict[str, torch.Tensor] = {}

    def loss_for_batch(items, labels, mask, neg_sample):
        step.update(items=items.detach().clone(), labels=labels.detach().clone(),
                    negs=neg_sample.detach().clone())
        loss = type(model).loss_for_batch(model, items, labels, mask, neg_sample)
        records.append(dict(step))
        return loss

    def scored(scores, *a, **k):
        step["scores"] = scores.detach().clone()
        return loss_fn(scores, *a, **k)

    model.loss_for_batch = loss_for_batch
    gru4rec.LOSSES[model.loss_name] = scored

    def stop():
        del model.loss_for_batch
        gru4rec.LOSSES[model.loss_name] = loss_fn

    return stop


def parameters(runner: NeuralBaselineRunner) -> Dict[str, torch.Tensor]:
    return {n: p.detach() for n, p in runner.model.params.named_parameters()}


def accumulators(runner: NeuralBaselineRunner) -> Dict[str, torch.Tensor]:
    """{parameter name: Adagrad's accumulator}; zeros where the optimizer
    holds none (an update that never ran)."""
    opt = runner.model.optimizer
    return {n: opt.state[p]["acc"] if "acc" in opt.state.get(p, {}) else torch.zeros_like(p)
            for n, p in runner.model.params.named_parameters()}


def rows_changed(before: torch.Tensor, after: torch.Tensor) -> torch.Tensor:
    """[rows] bool: the rows of a table whose bits changed."""
    a, b = before.reshape(before.shape[0], -1), after.reshape(after.shape[0], -1)
    return (a.view(torch.int32) != b.view(torch.int32)).any(1)


def id_rows(n_ids: int, n_rows: int, rng: np.random.Generator) -> np.ndarray:
    """[n_ids] table row of each article id: 0 for 0, the others spread
    over rows 1 .. n_rows - 1 by a seeded injective map."""
    out = np.zeros(n_ids, np.int64)
    out[1:] = rng.choice(np.arange(1, n_rows, dtype=np.int64), n_ids - 1, replace=False)
    return out
