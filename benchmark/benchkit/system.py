"""The system under test, ``chameleon_recsys_tpu_torch``, built from a
configuration file: its schemas and ``NARConfig``, its model loaded with the
benchmark's weights, its click stream warmed with the benchmark's history,
and its two entry points, ``TemporalHarness`` and ``NARServer``.  The only
module of the benchmark that imports the system."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from chameleon_recsys_tpu_torch.config import (
    ArticleFeaturesSchema,
    FeatureSpec,
    NARConfig,
    RunConfig,
    SessionFeaturesSchema,
)
from chameleon_recsys_tpu_torch.data.collate import Session
from chameleon_recsys_tpu_torch.models.nar import NARModel
from chameleon_recsys_tpu_torch.serve import NARServer
from chameleon_recsys_tpu_torch.state.stream_state import init_stream_state, update_stream_state
from chameleon_recsys_tpu_torch.train import temporal
from chameleon_recsys_tpu_torch.train.steps import init_train_state


def _spec(row) -> FeatureSpec:
    name, kind, arg = row
    if kind == "categorical":
        return FeatureSpec(name, kind, int(arg))
    return FeatureSpec(name, kind, dtype=arg)


def schemas(config: dict):
    sessions = SessionFeaturesSchema(
        single=tuple(_spec(r) for r in config["session_single"]),
        sequence=tuple(_spec(r) for r in config["session_sequence"]))
    articles = ArticleFeaturesSchema(
        features=tuple(_spec(r) for r in config["article_features"]))
    return sessions, articles


def nar_config(config: dict) -> NARConfig:
    return NARConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in config["nar"].items()})


def build_model(config: dict, weights: Mapping[str, torch.Tensor], device) -> NARModel:
    """The system's model on ``device`` holding ``weights``; its parameter
    names and shapes must be those the configuration gives."""
    sessions, articles = schemas(config)
    with torch.device(device):
        model = NARModel(nar_config(config), sessions, articles, int(config["ace_dim"]))
    own = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    given = {n: tuple(p.shape) for n, p in weights.items()}
    if own != given:
        raise RuntimeError(f"the model's parameters differ from the configuration's: "
                           f"{sorted(set(own.items()) ^ set(given.items()))[:6]}")
    model.load_state_dict(weights, strict=True)
    return model


def warm_stream(config: dict, history_ids: np.ndarray, history_ts: np.ndarray, device):
    cfg = nar_config(config)
    stream = init_stream_state(cfg, int(config["num_items"]), device=device)
    return update_stream_state(stream, torch.as_tensor(history_ids, device=device),
                               torch.as_tensor(history_ts, device=device), cfg)


def make_harness(config: dict, corpus, weights, history, sampler_seed: int, device,
                 model_dir: str):
    """A ``TemporalHarness`` with no classical baselines whose train state
    is the benchmark's: the weights, the warmed stream, Adam, and the
    sampler's generator seeded from the run's seed."""
    sessions, articles = schemas(config)
    cfg = nar_config(config)
    harness = temporal.TemporalHarness(
        cfg, RunConfig(model_dir=model_dir), sessions, articles, corpus.ace,
        corpus.metadata, benchmarks=(), device=device)
    model = build_model(config, weights, device)
    generator = torch.Generator(device=device).manual_seed(int(sampler_seed) % (2 ** 63))
    harness.state = init_train_state(model, warm_stream(config, *history, device), generator)
    return harness


def make_server(config: dict, corpus, weights, history, device) -> NARServer:
    sessions, articles = schemas(config)
    return NARServer(nar_config(config), sessions, articles, weights,
                     warm_stream(config, *history, device), corpus.ace, corpus.metadata,
                     device=device)


def to_sessions(dicts) -> list:
    return [Session(session_id=d["id"], user_id=d["user"], session_start=d["start"],
                    item_ids=d["items"], timestamps=d["ts"], context=d["ctx"])
            for d in dicts]


def adam_first_moments(harness) -> Dict[str, torch.Tensor]:
    """{parameter name: Adam's first moment} of the harness's train state."""
    opt = harness.state.optimizer
    return {n: opt.state[p]["exp_avg"] for n, p in harness.state.model.named_parameters()
            if p in opt.state}


def parameters(harness) -> Dict[str, torch.Tensor]:
    return dict(harness.state.model.named_parameters())


def adam_betas(harness):
    return harness.state.optimizer.param_groups[0]["betas"]


def wrap_step(name: str, wrapper):
    """Put ``wrapper(original)`` in the harness's place of step ``name``;
    returns a function that puts the original back."""
    original = getattr(temporal, name)
    setattr(temporal, name, wrapper(original))
    return lambda: setattr(temporal, name, original)
