"""Hyperparameter sweep runner (port of ``chameleon_recsys_tpu/train/sweep.py``).

Local replacement for the reference's ML Engine hypertuning
(nar_module/nar_mlengine_hypertuning.yaml:1-51): a discrete grid (or a
random subsample of it) over ``NARConfig`` fields, each trial running the
temporal harness in a trial subdirectory, ranked by a chosen metric
(default ``mrr_at_n``, the reference's objective).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import random
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from ..config import NARConfig, RunConfig
from .temporal import TemporalHarness

log = logging.getLogger("chameleon_tpu.sweep")


@dataclasses.dataclass
class TrialResult:
    trial_id: int
    overrides: Dict
    objective: float
    metrics: Dict


# Reference ML Engine parameterName -> NARConfig field
# (nar_mlengine_hypertuning.yaml:9-51 against the tf.flags they name,
# nar_trainer_gcom.py:37-93)
_MLENGINE_PARAM_MAP = {
    "batch_size": "batch_size",
    "train_total_negative_samples": "negative_samples",
    "eval_total_negative_samples": "eval_negative_samples",
    "CAR_embedding_size": "car_embedding_size",
    "rnn_units": "rnn_units",
    "rnn_num_layers": "rnn_num_layers",
    "learning_rate": "learning_rate",
    "dropout_keep_prob": "keep_prob",
    "reg_l2": "reg_weight_decay",
    "reg_l2_rate": "reg_weight_decay",
    "softmax_temperature": "softmax_temperature",
    "novelty_reg_factor": "novelty_reg_factor",
}


@dataclasses.dataclass
class SweepSpec:
    """Declarative sweep description (reference
    nar_mlengine_hypertuning.yaml:1-51)."""

    param_grid: Dict[str, List]
    objective: str = "mrr_at_n"
    goal: str = "MAXIMIZE"
    max_trials: Optional[int] = None
    max_parallel: int = 1


def load_sweep_spec(path: str) -> SweepSpec:
    """A YAML or JSON sweep spec, in either layout:
      * the reference's ML Engine layout, ``trainingInput.hyperparameters.
        {goal, hyperparameterMetricTag, maxTrials, maxParallelTrials, params:
        [{parameterName, type: DISCRETE, discreteValues: [...]}]}``
        (nar_mlengine_hypertuning.yaml:1-51), each parameterName translated
        through the reference-flag -> NARConfig map;
      * the flat layout, ``{params: {field: [values]}, objective, goal,
        max_trials, max_parallel}`` in NARConfig field names.
    A ``.yaml`` / ``.yml`` spec needs PyYAML."""
    text = Path(path).read_text()
    if str(path).endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as err:
            raise ImportError(
                f"reading the YAML sweep spec {path} needs PyYAML (the yaml "
                "module); give the spec as JSON instead") from err
        spec = yaml.safe_load(text)
    else:
        spec = json.loads(text)

    if "trainingInput" in spec:  # the ML Engine layout
        hp = spec["trainingInput"]["hyperparameters"]
        param_grid: Dict[str, List] = {}
        for param in hp.get("params", []):
            name = param["parameterName"]
            if param.get("type", "DISCRETE").upper() != "DISCRETE":
                raise ValueError(
                    f"only DISCRETE params are supported, got "
                    f"{param.get('type')} for {name}"
                )
            param_grid[_MLENGINE_PARAM_MAP.get(name, name)] = list(param["discreteValues"])
        return SweepSpec(
            param_grid=param_grid,
            objective=hp.get("hyperparameterMetricTag", "mrr_at_n"),
            goal=hp.get("goal", "MAXIMIZE"),
            max_trials=hp.get("maxTrials"),
            max_parallel=int(hp.get("maxParallelTrials", 1)),
        )
    return SweepSpec(
        param_grid={k: list(v) for k, v in spec["params"].items()},
        objective=spec.get("objective", "mrr_at_n"),
        goal=spec.get("goal", "MAXIMIZE"),
        max_trials=spec.get("max_trials"),
        max_parallel=int(spec.get("max_parallel", 1)),
    )


def grid(param_grid: Dict[str, Sequence]) -> List[Dict]:
    """Every combination of a discrete grid (the spec's DISCRETE params)."""
    keys = list(param_grid)
    return [dict(zip(keys, values))
            for values in itertools.product(*(param_grid[k] for k in keys))]


def run_sweep(
    base_cfg: NARConfig,
    run_cfg: RunConfig,
    param_grid: Dict[str, Sequence],
    harness_factory: Callable[[NARConfig, RunConfig], TemporalHarness],
    hour_source: Callable[[int], Sequence],
    hours: Sequence[int],
    objective: str = "mrr_at_n",
    max_trials: Optional[int] = None,
    seed: int = 42,
    max_parallel: int = 1,
    goal: str = "MAXIMIZE",
) -> List[TrialResult]:
    """Run the trials; returns their results best first under ``goal``
    (MAXIMIZE or MINIMIZE, hypertuning yaml:2-8) and writes them to
    ``model_dir/sweep_results.json``.

    Past ``max_trials`` combinations a ``random.Random(seed)`` sample of
    them runs.  A trial's objective is the mean of ``objective`` over its
    eval rows; a trial without one sorts last under either goal.
    ``max_parallel`` > 1 runs that many trials at once on a thread pool
    (the reference's ``maxParallelTrials: 2``, yaml:8): each trial owns its
    harness, its state, its generators and its subdirectory, so the results
    are the serial order's (on the card up to ``index_add_``'s float
    atomics, which make even two serial runs differ in the last bits)."""
    trials = grid(param_grid)
    if max_trials is not None and len(trials) > max_trials:
        trials = random.Random(seed).sample(trials, max_trials)
    worst = float("-inf") if goal.upper() == "MAXIMIZE" else float("inf")

    def run_trial(trial_id: int, overrides: Dict) -> TrialResult:
        cfg = dataclasses.replace(base_cfg, **overrides)
        trial_run_cfg = dataclasses.replace(
            run_cfg, model_dir=str(Path(run_cfg.model_dir) / f"trial_{trial_id:03d}"))
        rows = harness_factory(cfg, trial_run_cfg).run(hour_source, hours=hours)
        values = [r[objective] for r in rows if objective in r]
        value = float(sum(values) / len(values)) if values else worst
        log.info("trial %d %s -> %s=%.5f", trial_id, overrides, objective, value)
        return TrialResult(trial_id, overrides, value, rows[-1] if rows else {})

    if max_parallel > 1 and len(trials) > 1:
        with ThreadPoolExecutor(max_workers=max_parallel) as pool:
            results = list(pool.map(run_trial, range(len(trials)), trials))
    else:
        results = [run_trial(i, o) for i, o in enumerate(trials)]

    results.sort(key=lambda r: -r.objective if goal.upper() == "MAXIMIZE" else r.objective)
    out = Path(run_cfg.model_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "sweep_results.json", "w") as f:
        json.dump([dataclasses.asdict(r) for r in results], f, indent=2, default=str)
    return results
