"""Streaming temporal train/eval harness.

Port of ``chameleon_recsys_tpu/train/temporal.py::TemporalHarness``, the
reference's primary entry point (nar_trainer_gcom.py:505-525): train on hour
chunks ``t..t+n``, evaluate on hour ``t+n+1``, repeat, with the streaming
state checkpointed around every eval so evaluation never pollutes
training-time popularity/recency (nar_model.py:1410-1415, 1691-1693).
Checkpoint/resume persists the full unit: parameters, Adam's state, the
stream, the sampler's generator, the hour cursor and the metrics log, in
this package's own format (``train/checkpoint.py``).

The harness drives ``train.steps.train_step`` and ``eval_step``, looked up
as this module's names at call time.  It runs on ``cuda`` unless given
``device="cpu"``.  Beside CHAMELEON it runs any of this package's classical
baselines (``baselines/``), uploads ``model_dir`` to an artifact store on
every export (``utils/artifact_store.py``) and writes the per-step scalars
and per-hour parameter histograms (``utils/summary.py``).  Beside the
pickle (``save_checkpoint``, the default) it writes the JAX harness's
directory checkpoint (orbax there) through ``torch.distributed.checkpoint``
(``save_checkpoint_dcp`` / ``load_checkpoint_dcp``).

Multi-GPU (``mesh_plan``, ``parallel/``): one harness per rank.  Every rank
collates the same global batches of ``batch_size`` sessions and steps on
its block of them (``parallel/sharded.py``), so a run equals the one-device
run with ``train_compaction_groups`` = data parallelism on the same batches.
The row-sharded tables and their Adam moments stay on their ranks; the
stream is replicated.  The host tier runs on model index 0 of each data
index: the co-occurrences and the baselines learn from the global batch
(the same on each); in an eval hour each ranks its own block of every batch
with every baseline, the tier's costly half, and sends those ranked lists
with its eval fetches' rows to rank 0 (``_rank_blocks``), which scores the
whole batch as one device does: the metric suite, the cold-start tracking
and the eval logs.  So the eval row is the one-device row (a stochastic
baseline draws per rank).  Rank 0 alone writes ``model_dir``, the store and
the pickle checkpoint (gathered from every rank's rows); in the directory
checkpoint every rank writes its own rows.

The hours open the program's spans (``utils/profiling.py::span``), a batch
at a time: ``nar.collate``, ``nar.put_batch``, ``nar.train_step`` (with
``train/steps.py``'s ``nar.train_step.*`` inside), ``nar.host_tier`` and
the hour's ``nar.train.wait``; in an eval hour ``nar.eval.setup``,
``nar.collate``, ``nar.eval.dispatch``, ``nar.eval.wait``,
``nar.eval.metrics``, ``nar.eval.baselines``, ``nar.eval.cold_start``,
``nar.host_tier`` and ``nar.eval.results``.  They cost a flag check while
tracing is off; ``last_eval_phase_seconds`` sums the eval spans either way.
"""
from __future__ import annotations

import logging
import os
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..baselines.benchmarks import BenchmarkRecommender, StreamStateView
from ..config import ArticleFeaturesSchema, NARConfig, RunConfig, SessionFeaturesSchema
from ..data.collate import Session, batches_from_sessions
from ..metrics.evaluation import (
    ColdStartAnalysisState,
    compute_metrics_results,
    create_eval_metrics,
    update_metrics,
)
from ..models.nar import NARModel
from ..parallel.distributed import barrier, gather_object
from ..parallel.mesh import batch_sharding
from ..state.host_state import HostState
from ..state.stream_state import init_stream_state
from ..utils.io import (
    append_json_lines,
    deserialize,
    save_eval_benchmark_metrics_csv,
    serialize,
)
from ..utils.profiling import ThroughputMeter, span, spanned
from ..utils.summary import HistogramWriter, ScalarWriter
from .checkpoint import (
    load_train_state_dcp,
    pack_train_state,
    save_train_state_dcp,
    unpack_train_state,
)
from .steps import TrainState, eval_step, init_train_state, train_step

log = logging.getLogger("chameleon_recsys_tpu_torch.temporal")


@dataclass
class BenchmarkSpec:
    recommender: type
    params: dict = field(default_factory=dict)


@dataclass
class HarnessArtifacts:
    eval_sessions_metrics_log: List[Dict] = field(default_factory=list)
    sessions_negative_items_log: Optional[List[Dict]] = None
    sessions_chameleon_recommendations_log: Optional[List[Dict]] = None


class TemporalHarness:
    """Drives the NAR train and eval steps over an hour-indexed session
    source.

    ``hour_source(hour) -> List[Session]`` abstracts the per-hour data files
    (one gzipped TFRecord per hour in the reference, datasets.py:166-178).
    The arguments are the JAX harness's plus ``device`` (under a
    ``mesh_plan``, the plan's device).
    """

    def __init__(
        self,
        cfg: NARConfig,
        run_cfg: RunConfig,
        session_schema: SessionFeaturesSchema,
        article_schema: ArticleFeaturesSchema,
        ace_matrix,
        metadata,
        benchmarks: Sequence[BenchmarkSpec] = (),
        log_negative_samples: bool = False,
        log_recommendations: bool = False,
        eval_metrics_by_session_position: bool = False,
        eval_cold_start: bool = False,
        artifact_store=None,
        artifact_remote_path: str = "",
        mesh_plan=None,
        mesh_min_rows: int = 4096,
        benchmark_workers: Optional[int] = None,
        save_scalars: bool = False,
        save_histograms: bool = False,
        histograms_every_n_hours: int = 1,
        device="cuda",
    ):
        # Multi-GPU: with a MeshPlan each rank steps on its block of the
        # global batches through the sharded programs (parallel/sharded.py)
        self.mesh_plan = mesh_plan
        self.mesh_min_rows = mesh_min_rows
        self._sharded = None
        if mesh_plan is not None and cfg.batch_size % mesh_plan.data_parallelism:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by "
                f"data_parallelism {mesh_plan.data_parallelism}"
            )
        if mesh_plan is not None:
            device = mesh_plan.device
        # the ranks that run the host tier, and the one that writes model_dir
        self._host_tier = mesh_plan is None or mesh_plan.model_index == 0
        self._primary = mesh_plan is None or mesh_plan.rank == 0
        for spec in benchmarks:
            if not (isinstance(spec.recommender, type)
                    and issubclass(spec.recommender, BenchmarkRecommender)):
                raise TypeError(
                    f"the baseline {spec.recommender!r} is no subclass of this "
                    "package's baselines.BenchmarkRecommender"
                )
        # Remote artifact sync (the reference's GCS workflow shape,
        # gcs_utils.py:22-109): every export also uploads model_dir to the
        # store.  None = plain local files only.
        self.artifact_store = artifact_store
        self.artifact_remote_path = artifact_remote_path
        self.cfg = cfg
        self.run_cfg = run_cfg
        self.session_schema = session_schema
        self.article_schema = article_schema
        self.device = torch.device(device)
        self.ace_matrix_np = np.asarray(ace_matrix, np.float32)
        self.ace_matrix = torch.from_numpy(self.ace_matrix_np).to(self.device)
        self.metadata = {
            name: torch.as_tensor(
                np.asarray(col, np.float32 if np.asarray(col).dtype.kind == "f"
                           else np.int64),
                device=self.device,
            )
            for name, col in dict(metadata).items()
        }
        # Full [B, T, 1+K] ranking (+ probs) fetched only when per-session
        # recommendation logs need it; otherwise top-N ids suffice for the
        # whole host metric tier.
        self.fetch_full_ranking = log_recommendations
        self.state: Optional[TrainState] = None
        self.host_state = HostState(article_schema.num_items)
        self.eval_cold_start = eval_cold_start
        self.cold_start_state = ColdStartAnalysisState()
        self.last_eval_phase_seconds: Dict[str, float] = {}
        self.eval_metrics_by_session_position = eval_metrics_by_session_position

        self.artifacts = HarnessArtifacts(
            sessions_negative_items_log=[] if log_negative_samples else None,
            sessions_chameleon_recommendations_log=(
                [] if log_recommendations else None
            ),
        )

        self._state_view = StreamStateView(
            self.host_state,
            np.zeros(cfg.recent_clicks_buffer_max_size, np.int32),
            np.full(
                article_schema.num_items,
                1.0 / cfg.recent_clicks_for_normalization,
                np.float32,
            ),
            np.zeros(article_schema.num_items, np.int64),
        )
        self.bench_classifiers: List[BenchmarkRecommender] = [
            spec.recommender(
                self._state_view,
                dict(spec.params),
                self._new_metric_set(),
            )
            for spec in benchmarks
        ]
        if eval_cold_start:
            for clf in self.bench_classifiers:
                clf.cold_start_state = ColdStartAnalysisState()
        # Parallel benchmark tier: each classical baseline's train/evaluate is
        # independent per batch (own metric set, own benchmarks_states slot,
        # read-only StreamStateView/co-occurrence), and the heavy work is
        # numpy (GIL-released), so the per-classifier loops run on a thread
        # pool.  Outputs are bit-identical to the serial order.
        # ``benchmark_workers``: None = auto (one thread per classifier,
        # capped at cpu_count); 0/1 = serial.  A classifier drawing from the
        # process-global Python RNG (sampling_strategy='random') is
        # order-sensitive across threads, so auto is then serial.
        uses_global_rng = any(
            getattr(c, "sampling_strategy", "") == "random"
            for c in self.bench_classifiers
        )
        if benchmark_workers is None:
            benchmark_workers = (
                0
                if uses_global_rng
                else min(len(self.bench_classifiers), os.cpu_count() or 1)
            )
        self._bench_pool = (
            ThreadPoolExecutor(
                max_workers=benchmark_workers, thread_name_prefix="bench"
            )
            if benchmark_workers > 1 and len(self.bench_classifiers) > 1
            else None
        )
        if self._bench_pool is not None:
            # release the worker threads when the harness is collected
            weakref.finalize(self, self._bench_pool.shutdown, False)
        # Per-step observability channel (the reference's TensorBoard
        # scalars and --save_histograms, nar_trainer_gcom.py:54): JSON-lines
        # sinks under model_dir, written once an hour.
        self.scalar_writer = (ScalarWriter(run_cfg.model_dir)
                              if save_scalars and self._primary else None)
        self.save_histograms = save_histograms
        self.histogram_writer = (
            HistogramWriter(run_cfg.model_dir) if save_histograms and self._primary
            else None
        )
        self.histograms_every_n_hours = max(1, histograms_every_n_hours)
        self.hours_trained = 0
        # Count of completed chunk evals — checkpointed so a resume from a
        # checkpoint taken between a chunk's train and its eval re-runs that
        # eval instead of silently thinning the eval CSV.
        self.evals_done = 0
        self.train_meter = ThroughputMeter("train")

    # ------------------------------------------------------------------
    def _each_benchmark(self, fn):
        """Apply ``fn`` to every benchmark classifier, on the thread pool
        when one is configured.  ``list()`` re-raises worker exceptions."""
        if self._bench_pool is None:
            for clf in self.bench_classifiers:
                fn(clf)
        else:
            list(self._bench_pool.map(fn, self.bench_classifiers))

    def _new_metric_set(self):
        return create_eval_metrics(
            self.cfg.metrics_top_n,
            self.cfg.eval_negative_sample_relevance,
            self.eval_metrics_by_session_position,
            self.ace_matrix_np,
            self._state_view.get_recent_clicks_buffer(),
        )

    def _refresh_state_view(self, arrays=None):
        """Copy the stream's buffer and popularity to the host view; the
        eval loop passes the arrays it captured for the batch (``arrays``),
        since by then the state is one step ahead."""
        if arrays is None:
            st = self.state.stream
            arrays = (st.buffer_ids, st.recent_pop_norm, st.global_pop)
        self._state_view.refresh(*(np.asarray(a.cpu()) for a in arrays))

    def init_state(self):
        """A fresh train state: ``NARModel`` initialised from
        ``run_cfg.random_seed``, an empty stream, Adam, and the sampler's
        generator seeded with the same seed."""
        seed = self.run_cfg.random_seed
        model = NARModel(self.cfg, self.session_schema, self.article_schema,
                         self.ace_matrix_np.shape[1])
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model.to(self.device)
        if self.mesh_plan is not None:
            from ..parallel.sharded import shard_nar_programs

            # every rank initialises the same whole model, then keeps its rows
            self._sharded = shard_nar_programs(self.mesh_plan, model, self.ace_matrix_np,
                                               self.mesh_min_rows)
            self.ace_matrix = self._sharded.local_ace(
                torch.from_numpy(self.ace_matrix_np).to(self.device))
        stream = init_stream_state(self.cfg, self.article_schema.num_items,
                                   device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_train_state(model, stream, generator)

    def _put_batch(self, np_batch):
        if self._sharded is not None:
            from ..parallel.sharded import put_batch

            return put_batch(self._sharded, np_batch)
        return {k: torch.from_numpy(v).to(self.device) for k, v in np_batch.items()}

    def _train_step(self, batch):
        if self._sharded is not None:
            return self._sharded.train_step(self.state, batch, self.ace_matrix,
                                            self.metadata)
        return train_step(self.state, batch, self.ace_matrix, self.metadata)

    def _eval_step(self, batch):
        kwargs = dict(generator=self.state.generator,
                      fetch_full_ranking=self.fetch_full_ranking)
        if self._sharded is not None:
            return self._sharded.eval_step(
                self.state.model, self.state.stream, batch, self.ace_matrix,
                self.metadata, **kwargs)
        return eval_step(self.state.model, self.state.stream, batch, self.ace_matrix,
                         self.metadata, **kwargs)

    def _batches(self, source):
        """Batch iterator over an hour's data: a Session sequence, or any
        object exposing ``batches(batch_size, max_session_length)``."""
        if hasattr(source, "batches"):
            return source.batches(self.cfg.batch_size, self.cfg.max_session_length)
        return batches_from_sessions(
            source,
            self.session_schema,
            self.cfg.batch_size,
            self.cfg.max_session_length,
        )

    # ------------------------------------------------------------------
    def _ensure_initialized(self):
        if self.state is None:
            self.init_state()

    def train_hour(self, sessions: Sequence[Session]) -> Dict[str, float]:
        self._ensure_initialized()
        n_steps, step_metrics, first_step = 0, [], self.host_state.current_step + 1
        self.train_meter.start()
        for np_batch in spanned("nar.collate", self._batches(sessions)):
            with span("nar.put_batch"):
                batch = self._put_batch(np_batch)
            with span("nar.train_step"):
                self.state, metrics = self._train_step(batch)
            # keep the device scalars: converting here would sync every step
            step_metrics.append(metrics)
            n_steps += 1
            self.train_meter.stop(
                1, int((np_batch["session_size"] > 0).sum()), 0
            )
            # Host-side structures learn from train batches too
            # (reference nar_model.py:1628-1650 runs in both modes).
            # First-click tracking is unconditional like the reference hook
            # (nar_model.py:1481-1494).
            with span("nar.host_tier"):
                self._register_batch_clicks(np_batch)
                if self._host_tier:
                    self._train_host_side(np_batch)
            self.train_meter.start()
        # one fetch of the hour's scalars, inside the meter: it waits for the
        # device, so the train throughput counts the device's work.  float64
        # holds every f32 and integer scalar exactly.  The names are sorted,
        # as the JAX step's metrics come back (a pytree's dict keys).
        names = ["ce_loss"]
        if self.scalar_writer is not None and step_metrics:
            names = sorted(step_metrics[0])
        with span("nar.train.wait"):
            fetched = (
                torch.stack([torch.stack([m[k].double() for k in names])
                             for m in step_metrics]).cpu().tolist()
                if step_metrics else []
            )
        self.train_meter.stop(0)
        self.hours_trained += 1
        if self.scalar_writer is not None and fetched:
            for i, values in enumerate(fetched):
                self.scalar_writer.write(first_step + i, dict(zip(names, values)))
            self.scalar_writer.flush()
        if (
            self.save_histograms
            and self.hours_trained % self.histograms_every_n_hours == 0
        ):
            # every rank takes part in gathering the row shards
            params = (self.state.model if self._sharded is None else
                      self._sharded.full_tensors(dict(self.state.model.named_parameters())))
            if self.histogram_writer is not None:
                self.histogram_writer.write_tree(
                    int(self.host_state.current_step), params, prefix="params/",
                )
        losses = [values[names.index("ce_loss")] for values in fetched]
        avg_loss = float(np.mean(losses)) if losses else 0.0
        return {"steps": n_steps, "avg_ce_loss": avg_loss}

    def _register_batch_clicks(self, np_batch):
        """Step counter + first-click registration (must run before any
        cold-start recommendation check for this batch, reference
        nar_model.py:1481-1494)."""
        self.host_state.increment_current_step()
        clicked = np_batch["item_clicked"]
        labels = np_batch["label_next_item"]
        nonzero = set(clicked.reshape(-1)) | set(labels.reshape(-1))
        nonzero.discard(0)
        self.host_state.update_items_first_click_step(np.array(sorted(nonzero)))

    def _train_host_side(self, np_batch, force_refresh: bool = False,
                         refresh_arrays=None):
        if not self.bench_classifiers and not self.eval_cold_start:
            if force_refresh:
                self._refresh_state_view(refresh_arrays)
            return
        clicked = np_batch["item_clicked"]
        all_clicked = np.concatenate(
            [clicked, np_batch["label_last_item"]], axis=1
        )
        self.host_state.update_items_coocurrences(all_clicked)
        if force_refresh:
            self._refresh_state_view(refresh_arrays)
        # else: train hours — baselines' train() only touches host-side
        # dicts, and every eval consumer refreshes the view first
        self._each_benchmark(
            lambda clf: clf.train(
                np_batch["user_id"],
                np_batch["session_id"],
                clicked,
                np_batch["label_next_item"],
            )
        )

    # ------------------------------------------------------------------
    def _fetch_async(self, tensors: Dict[str, torch.Tensor]):
        """Start the device->host copies of ``tensors``: on the card into
        pinned host buffers, with an event recorded after them (wait on it
        before reading); on the CPU the tensors are the host copies."""
        if self.device.type != "cuda":
            return dict(tensors), None
        host = {}
        for name, tensor in tensors.items():
            buffer = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            buffer.copy_(tensor, non_blocking=True)
            host[name] = buffer
        event = torch.cuda.Event()
        event.record()
        return host, event

    def evaluate_hour(self, sessions: Sequence[Session]) -> Dict[str, float]:
        """Full eval pass over one hour; stream/host state snapshotted and
        restored afterwards (the temporal-protocol guard)."""
        self._ensure_initialized()
        # Per-phase wall accounting, exposed as self.last_eval_phase_seconds;
        # "device" is the dispatch plus the wait for the batch's fetches.
        # Each phase is the sum of its spans, timed whether tracing is on
        # or off.
        phases = {
            "device": 0.0,
            "chameleon_metrics": 0.0,
            "benchmarks": 0.0,
            "cold_start": 0.0,
            "host_state": 0.0,
        }
        with span("nar.eval.setup"):
            # The steps never write a stream tensor in place (each returns
            # new ones), so holding the references is the snapshot.
            stream_snapshot = self.state.stream
            self.host_state.save_state_checkpoint()

            # Metric sets are rebuilt per eval with the current buffer
            # snapshot (ItemCoverage seeds its clicked-items set from it).
            self._refresh_state_view()
            streaming = self._new_metric_set()
            for clf in self.bench_classifiers:
                clf.streaming_metrics = self._new_metric_set()

        hit_sum = rr_sum = label_count = 0.0
        sessions_count = clicks_count = 0
        t_start = time.time()

        # The loop is a one-step-lookahead pipeline: batch i+1's eval step is
        # dispatched, and its device->host copies queued, before batch i's
        # fetches are waited on, so the card computes ahead of the host
        # metric and benchmark tiers.  Host processing stays in batch order,
        # so every value is the serial loop's.  On the CPU each step runs
        # when it is called and the loop is serial.
        def _dispatch(np_batch):
            batch = self._put_batch(np_batch)
            stream, dev_metrics, fetches = self._eval_step(batch)
            self.state = self.state._replace(stream=stream)
            wanted = {f"m_{k}": v for k, v in dev_metrics.items()}
            if self._host_tier:
                wanted.update(fetches, view_buffer_ids=stream.buffer_ids,
                              view_recent_pop_norm=stream.recent_pop_norm,
                              view_global_pop=stream.global_pop)
            host, event = self._fetch_async(wanted)
            return np_batch, host, event

        batch_iter = spanned("nar.collate", self._batches(sessions))
        pending = None
        while True:
            np_next = next(batch_iter, None)
            if np_next is not None:
                with span("nar.eval.dispatch", phases, "device"):
                    current = _dispatch(np_next)
            else:
                current = None
            if pending is None:
                if current is None:
                    break
                pending = current
                continue
            np_batch, host, event = pending

            with span("nar.eval.wait", phases, "device"):
                if event is not None:
                    event.synchronize()
                hit_sum += float(host["m_hit_sum"])
                rr_sum += float(host["m_rr_sum"])
                label_count += float(host["m_label_count"])
                clicks_count += int(host["m_clicks"])
                sessions_count += int(host["m_sessions"])
                if self._host_tier:
                    fetched = (
                        host["predicted_ids"].numpy(),
                        host["predicted_probs"].numpy() if "predicted_probs" in host
                        else None,
                        host["labels"].numpy(),
                        host["neg_items"].numpy(),
                        host["clicked_items"].numpy(),
                    )
                    view_arrays = (host["view_buffer_ids"], host["view_recent_pop_norm"],
                                   host["view_global_pop"])
                    pop_norm = self._state_view.get_articles_recent_pop_norm()
            if not self._host_tier:
                pending = current
                if pending is None:
                    break
                continue

            ranked = None
            if self._sharded is not None:
                with span("nar.eval.baselines", phases, "benchmarks"):
                    ranked, fetched = self._rank_blocks(np_batch, fetched)
            preds, probs, labels, neg_items, clicked = fetched
            if self._primary:
                with span("nar.eval.metrics", phases, "chameleon_metrics"):
                    update_metrics(
                        preds,
                        labels,
                        pop_norm[labels],
                        pop_norm[preds],
                        clicked,
                        streaming,
                        recommender="chameleon",
                    )
                    self._log_eval_batch(np_batch, labels, neg_items, preds, probs,
                                         pop_norm)

                with span("nar.eval.baselines", phases, "benchmarks"):
                    if ranked is None:
                        self._each_benchmark(
                            lambda clf: clf.evaluate(
                                np_batch["user_id"],
                                clicked,
                                labels,
                                topk=self.cfg.metrics_top_n,
                                eval_negative_items=neg_items,
                            )
                        )
                    else:
                        self._each_benchmark(
                            lambda clf: clf.record_eval(
                                ranked[id(clf)], clicked, labels,
                                topk=self.cfg.metrics_top_n
                            )
                        )
            # Cold-start bookkeeping runs after this batch's first-click
            # registration (reference order, nar_model.py:1481-1494).
            with span("nar.host_tier"):
                self._register_batch_clicks(np_batch)
            if self.eval_cold_start and self._primary:
                with span("nar.eval.cold_start", phases, "cold_start"):
                    self._update_cold_start(np_batch, labels, neg_items, preds)
            # force_refresh: the eval metric tier needs the view advanced to
            # this batch's post-step state, captured at dispatch time (the
            # state is one step ahead by now).
            with span("nar.host_tier", phases, "host_state"):
                self._train_host_side(
                    np_batch, force_refresh=True, refresh_arrays=view_arrays
                )
            pending = current
            if pending is None:
                break
        self.last_eval_phase_seconds = phases

        with span("nar.eval.results"):
            row: Dict[str, float] = {
                "hitrate_at_n": hit_sum / max(label_count, 1.0),
                "mrr_at_n": rr_sum / max(label_count, 1.0),
            }
            if self._primary:
                row.update(compute_metrics_results(streaming, recommender="chameleon"))
                for clf in self.bench_classifiers:
                    row.update(compute_metrics_results(clf.streaming_metrics,
                                                       clf.get_clf_suffix()))
            row["clicks_count"] = clicks_count
            row["sessions_count"] = sessions_count
            row.update(self.train_meter.result())  # sessions/s since start
            if self.eval_cold_start and self._primary:
                row["coldstart_chameleon"] = self.cold_start_state.get_statistics()
                for clf in self.bench_classifiers:
                    row[f"coldstart_{clf.get_clf_suffix()}"] = (
                        clf.cold_start_state.get_statistics()
                    )
            self.artifacts.eval_sessions_metrics_log.append(row)
            log.info(
                "eval done in %.1fs: HR@%d=%.4f MRR@%d=%.4f",
                time.time() - t_start,
                self.cfg.metrics_top_n,
                row["hitrate_at_n"],
                self.cfg.metrics_top_n,
                row["mrr_at_n"],
            )

            # restore pre-eval streaming state (train must not see eval's
            # future)
            self.state = self.state._replace(stream=stream_snapshot)
            self.host_state.restore_state_checkpoint()
        self.evals_done += 1
        return row

    def _rank_blocks(self, np_batch, fetched):
        """Under a mesh, the benchmark tier's costly half, data-parallel:
        this host-tier rank ranks its block of the eval batch with every
        baseline (each ranks a row alone), then the blocks and the eval
        fetches' rows (``fetched``: ids, probabilities or None, labels,
        negatives, clicks) go to rank 0 in data-index order.  Returns, on
        rank 0, {id(baseline): its ranked lists} and the fetches of the
        whole batch, as one device has them; elsewhere the rank's own."""
        blocks = batch_sharding(self.mesh_plan, np_batch)["user_id"]
        users = np_batch["user_id"][blocks]
        _, _, labels, neg_items, clicked = fetched
        ranked = {}

        def one(clf):
            ranked[id(clf)] = clf.eval_predictions(
                users, clicked, labels, topk=self.cfg.metrics_top_n,
                eval_negative_items=neg_items,
            )

        self._each_benchmark(one)
        mine = [ranked[id(clf)] for clf in self.bench_classifiers]
        parts = gather_object((fetched, mine), 0, self.mesh_plan.data_group)
        if parts is None:
            return ranked, fetched
        whole = tuple(None if arrays[0] is None else np.concatenate(arrays)
                      for arrays in zip(*(f for f, _ in parts)))
        lists = [np.concatenate(arrays) for arrays in zip(*(r for _, r in parts))]
        return {id(clf): x for clf, x in zip(self.bench_classifiers, lists)}, whole

    def _log_eval_batch(self, np_batch, labels, neg_items, preds, probs, pop_norm):
        neg_log = self.artifacts.sessions_negative_items_log
        if neg_log is not None:
            for sid, sess_labels, sess_negs in zip(
                np_batch["session_id"], labels, neg_items
            ):
                if sid == 0:  # padded batch row, not a session
                    continue
                neg_log.append(
                    {
                        "session_id": str(sid),
                        "negative_items": [
                            negs.tolist()
                            for lab, negs in zip(sess_labels, sess_negs)
                            if lab != 0
                        ],
                    }
                )
        rec_log = self.artifacts.sessions_chameleon_recommendations_log
        if rec_log is not None:
            probs_rounded = probs.round(decimals=7)
            for sid, sess_labels, sess_preds, sess_probs in zip(
                np_batch["session_id"], labels, preds, probs_rounded
            ):
                if sid == 0:  # padded batch row, not a session
                    continue
                pred_pops = pop_norm[sess_preds].round(decimals=7)
                mask = sess_labels != 0
                rec_log.append(
                    {
                        "session_id": str(sid),
                        "next_click_labels": sess_labels[mask].tolist(),
                        "predicted_item_ids": sess_preds[mask].tolist(),
                        "predicted_item_probs": sess_probs[mask].tolist(),
                        "predicted_item_norm_pop": pred_pops[mask].tolist(),
                    }
                )

    def _update_cold_start(self, np_batch, labels, neg_items, preds):
        """Cold-start tracking during eval (reference nar_model.py:1480-1501)."""
        top_n = self.cfg.metrics_top_n
        self.cold_start_state.update_items_num_steps_before_first_rec(
            preds[:, :, :top_n],
            self.host_state.items_first_click_step,
            self.host_state.current_step,
        )

        def one(clf):
            # Reuse this batch's eval predictions (stashed by clf.evaluate):
            # same inputs, same state, deterministic classifier → identical
            # to the reference's second predict call (nar_model.py:1496-1501).
            cached = getattr(clf, "_last_eval_preds", None)
            clf._last_eval_preds = None
            if cached is not None and cached[1] == top_n and not clf.is_stochastic():
                bench_preds = cached[0]
            else:
                valid = clf.get_valid_candidate_items(labels, neg_items)
                bench_preds = clf.predict(
                    np_batch["user_id"],
                    np_batch["item_clicked"],
                    valid_items=valid,
                    topk=top_n,
                )
            clf.cold_start_state.update_items_num_steps_before_first_rec(
                bench_preds,
                self.host_state.items_first_click_step,
                self.host_state.current_step,
            )

        self._each_benchmark(one)

    # ------------------------------------------------------------------
    def run(
        self,
        hour_source: Callable[[int], Sequence[Session]],
        hours: Sequence[int],
    ) -> List[Dict]:
        """The outer temporal loop (reference nar_trainer_gcom.py:505-525):
        for each chunk of ``training_hours_for_each_eval`` hours, train on the
        chunk then evaluate on the following hour.  After a
        ``load_checkpoint`` the hours already trained are skipped and a
        chunk's pending eval (checkpointed between its train and its eval)
        runs."""
        chunk = self.run_cfg.training_hours_for_each_eval
        hours = list(hours)
        self._ensure_initialized()
        initial_done = self.hours_trained

        for start in range(0, len(hours), chunk):
            train_hours = hours[start : start + chunk]
            for offset, h in enumerate(train_hours):
                if start + offset < initial_done:
                    continue
                stats = self.train_hour(hour_source(h))
                log.info("hour %d trained: %s", h, stats)
            eval_idx = start + chunk
            if eval_idx < len(hours) and self.evals_done < start // chunk + 1:
                self.evaluate_hour(hour_source(hours[eval_idx]))
            self._maybe_export()
        return self.artifacts.eval_sessions_metrics_log

    def _maybe_export(self):
        n = len(self.artifacts.eval_sessions_metrics_log)
        if n and n % self.run_cfg.save_results_each_n_evals == 0:
            self.export_artifacts()

    def export_artifacts(self):
        if not self._primary:
            return
        out = Path(self.run_cfg.model_dir)
        save_eval_benchmark_metrics_csv(
            self.artifacts.eval_sessions_metrics_log,
            out / "eval_stats_benchmarks.csv",
            self.run_cfg.training_hours_for_each_eval,
        )
        if self.artifacts.sessions_negative_items_log is not None:
            append_json_lines(
                out / "eval_sessions_negative_samples.json",
                self.artifacts.sessions_negative_items_log,
            )
            self.artifacts.sessions_negative_items_log.clear()
        if self.artifacts.sessions_chameleon_recommendations_log is not None:
            append_json_lines(
                out / "eval_chameleon_recommendations_log.json",
                self.artifacts.sessions_chameleon_recommendations_log,
            )
            self.artifacts.sessions_chameleon_recommendations_log.clear()
        if self.artifact_store is not None:
            self.artifact_store.upload_dir(out, self.artifact_remote_path)

    # ------------------------------------------------------------------
    # checkpoint/resume: the full unit (train/checkpoint.py has the format)
    def _host_payload(self) -> Dict:
        """The harness's own fields of a checkpoint, as the JAX harness names
        them."""
        return {
            "hours_trained": self.hours_trained,
            "evals_done": self.evals_done,
            "metrics_log": self.artifacts.eval_sessions_metrics_log,
            "host_cooccurrence": self.host_state.items_coocurrences,
            "host_first_click_step": self.host_state.items_first_click_step,
            "host_current_step": self.host_state.current_step,
            "host_benchmarks_states": self.host_state.benchmarks_states,
        }

    def _restore_host(self, payload) -> None:
        self.hours_trained = payload["hours_trained"]
        self.evals_done = payload["evals_done"]
        self.artifacts.eval_sessions_metrics_log = payload["metrics_log"]
        self.host_state.items_coocurrences = payload["host_cooccurrence"]
        self.host_state.items_first_click_step = payload["host_first_click_step"]
        self.host_state.current_step = payload["host_current_step"]
        self.host_state.benchmarks_states = payload["host_benchmarks_states"]
        self._refresh_state_view()

    def save_checkpoint(self, path=None):
        self._ensure_initialized()
        path = Path(path or Path(self.run_cfg.model_dir) / "checkpoint.pkl")
        payload = pack_train_state(self.state, self._sharded)
        if not self._primary:
            barrier(self.mesh_plan)  # the file is written when this returns
            return path
        payload.update(self._host_payload())
        serialize(path, payload)
        if self.mesh_plan is not None:
            barrier(self.mesh_plan)
        return path

    def load_checkpoint(self, path=None):
        """Every rank reads the file; under a mesh each keeps its rows (a
        checkpoint written at any layout loads at any other)."""
        path = Path(path or Path(self.run_cfg.model_dir) / "checkpoint.pkl")
        payload = deserialize(path)
        self._ensure_initialized()
        self.state = unpack_train_state(payload, self.state, self._sharded)
        self._restore_host(payload)

    # -- the directory backend, the counterpart of the JAX harness's orbax
    # one: the device state through torch.distributed.checkpoint, the host
    # structures (scipy csr, dicts) in a pickle sidecar
    def save_checkpoint_dcp(self, dir_path=None):
        """The counterpart of the JAX harness's ``save_checkpoint_orbax``:
        the train state (parameters, Adam, stream, generator, step) in
        ``dir_path/device_state`` (``train/checkpoint.py::save_train_state_dcp``;
        under a mesh every rank writes its own rows of the sharded tables,
        nothing is gathered) and the harness's fields in
        ``dir_path/host_state.pkl``.  Returns ``dir_path``."""
        self._ensure_initialized()
        dir_path = Path(dir_path or Path(self.run_cfg.model_dir) / "dcp_ckpt").absolute()
        save_train_state_dcp(dir_path / "device_state", self.state, self._sharded)
        if self._primary:
            serialize(dir_path / "host_state.pkl", self._host_payload())
        if self.mesh_plan is not None:
            barrier(self.mesh_plan)  # the sidecar is written when this returns
        return dir_path

    def load_checkpoint_dcp(self, dir_path):
        """Load a ``save_checkpoint_dcp`` directory.  As the JAX harness's
        ``load_checkpoint_orbax``, it wants an initialised harness
        (``init_state``): the live state is the template.  Under a mesh
        each rank reads its rows of the live layout, whatever layout wrote
        the directory."""
        if self.state is None:
            raise RuntimeError("initialize the harness (init_state) before restoring "
                               "a DCP checkpoint")
        dir_path = Path(dir_path).absolute()
        self.state = load_train_state_dcp(dir_path / "device_state", self.state,
                                          self._sharded)
        self._restore_host(deserialize(dir_path / "host_state.pkl"))
