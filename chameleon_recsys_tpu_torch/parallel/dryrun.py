"""A dry run of the multi-GPU production path over W spawned ranks.

The counterpart of the JAX package's ``dryrun_multichip``: a
``TemporalHarness`` with a ``MeshPlan`` on each rank (``dp x 2`` when W is
even, else ``W x 1``; grouped valid-row compaction, ``mesh_min_rows`` 64, so
the item embedding and the ACE matrix are row-sharded) over a multi-hour
slice: two train hours, the sharded eval step with the host tier on hour 3,
then a checkpoint, one more trained hour, the checkpoint restored and the
same hour trained again, which must give the same loss.  Both kernel flags
are on, as the G1 trainer sets them: on the card every rank launches the
UGRNN and fused-scorer kernels, and reports its launches.

    python -m chameleon_recsys_tpu_torch.parallel.dryrun --devices 4
    python -m chameleon_recsys_tpu_torch.parallel.dryrun --devices 4 --platform cpu

It runs on the card unless ``--platform cpu`` is given, and exits when the
card is asked for and there is none.  On the card the ranks talk over NCCL,
one card a rank (several ranks on one card need ``--backend gloo``); on the
CPU over gloo.
"""
from __future__ import annotations

import argparse
import socket
import tempfile
from typing import Dict, List

import numpy as np
import torch
import torch.multiprocessing as mp

from ..config import (
    ArticleFeaturesSchema,
    FeatureSpec,
    NARConfig,
    RunConfig,
    SessionFeaturesSchema,
)

NUM_ITEMS = 512  # a multiple of the model axis, small enough for a dry run
ACE_DIM = 16


def _schemas(num_items: int, num_users: int = 1000, num_categories: int = 16):
    article = ArticleFeaturesSchema(features=(
        FeatureSpec("article_id", "categorical", num_items),
        FeatureSpec("created_at_ts", "numerical", dtype="int"),
        FeatureSpec("category_id", "categorical", num_categories),
    ))
    session = SessionFeaturesSchema(
        single=(
            FeatureSpec("user_id", "categorical", num_users),
            FeatureSpec("session_id", "numerical", dtype="int"),
            FeatureSpec("session_start", "numerical", dtype="int"),
            FeatureSpec("session_size", "numerical", dtype="int"),
        ),
        sequence=(
            FeatureSpec("event_timestamp", "numerical", dtype="int"),
            FeatureSpec("item_clicked", "categorical", num_items),
            FeatureSpec("device", "categorical", 5),
            FeatureSpec("os", "categorical", 23),
            FeatureSpec("hour_sin", "numerical", dtype="float"),
        ),
    )
    return article, session


def layout(n_devices: int):
    """(data, model) parallelism of the dry run, as the JAX one lays it."""
    model_par = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // model_par, model_par


def dryrun_config(data_parallelism: int) -> NARConfig:
    dp = data_parallelism
    return NARConfig(
        car_embedding_size=32, rnn_units=16, rnn_num_layers=2,
        matching_layer_sizes=(16, 8, 8), negative_samples=4,
        negative_sample_from_buffer=32, eval_negative_samples=4,
        eval_negative_sample_from_buffer=32, recent_clicks_buffer_max_size=128,
        recent_clicks_for_normalization=64, batch_size=2 * dp, max_session_length=6,
        metrics_top_n=3,
        # the production compaction under a mesh: one group per data rank
        train_valid_row_capacity=8 * dp, train_compaction_groups=dp,
        # the kernels of the production path (the fused scorer takes three
        # matching layers)
        use_pallas_rnn=True, use_pallas_scorer=True,
    )


def _rank(rank: int, world: int, port: int, platform: str, backend: str,
          model_dir: str, queue) -> None:
    from ..data.synthetic import make_synthetic_corpus, synthetic_hour_sessions
    from ..ops.kernels import launch_counts
    from ..train.temporal import TemporalHarness
    from .distributed import initialize_multihost, snapshot_counts
    from .mesh import make_mesh

    try:
        initialize_multihost(f"localhost:{port}", world, rank, backend=backend)
        if platform == "cpu":
            device = torch.device("cpu")
            torch.set_num_threads(1)  # the ranks share the host's cores
        else:
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dp, model_par = layout(world)
        plan = make_mesh(dp, model_par, device=device)
        cfg = dryrun_config(dp)
        article_schema, session_schema = _schemas(NUM_ITEMS)
        corpus = make_synthetic_corpus(article_schema, ace_dim=ACE_DIM)
        harness = TemporalHarness(
            cfg, RunConfig(model_dir=model_dir, training_hours_for_each_eval=1),
            session_schema, article_schema, corpus.ace_matrix, corpus.metadata,
            mesh_plan=plan, mesh_min_rows=64,
        )

        def hour_source(h):
            return synthetic_hour_sessions(corpus, session_schema, h,
                                           2 * cfg.batch_size, cfg.max_session_length)

        stats = [harness.train_hour(hour_source(h)) for h in (0, 1)]
        row = harness.evaluate_hour(hour_source(2))
        ckpt = harness.save_checkpoint()
        post = harness.train_hour(hour_source(3))
        harness.load_checkpoint(ckpt)
        redo = harness.train_hour(hour_source(3))
        queue.put((rank, {
            "losses": [s["avg_ce_loss"] for s in stats + [post, redo]],
            "row": {k: v for k, v in row.items() if isinstance(v, (int, float))},
            "sharded": sorted(n for n, s in harness._sharded.state_sharding.items() if s),
            "ace_sharded": harness._sharded.ace_sharding is not None,
            "buffer_ids": harness.state.stream.buffer_ids.cpu().numpy(),
            "collectives": snapshot_counts(),
            "launches": launch_counts(),
        }))
    except BaseException as err:  # the parent reports it
        queue.put((rank, {"error": repr(err)}))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int = 4, platform: str = "cuda", backend: str = "",
                     timeout: float = 120.0) -> Dict:
    """Spawn ``n_devices`` ranks through the dry run; check every phase and
    return rank 0's results, with every rank's kernel launches in rank
    order under ``"launches_by_rank"``.  Raises on a failed rank or check;
    exits when ``platform`` is ``"cuda"`` and there is no card."""
    if platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --platform cpu to run on the CPU")
    backend = backend or ("gloo" if platform == "cpu" else "nccl")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as model_dir:
        procs = [ctx.Process(target=_rank, args=(r, n_devices, port, platform, backend,
                                                 model_dir, queue))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        try:
            results: List = [queue.get(timeout=timeout) for _ in procs]
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
    results = dict(results)
    errors = {r: res["error"] for r, res in results.items() if "error" in res}
    if errors:
        raise RuntimeError(f"dry run failed on ranks {errors}")
    first = results[0]
    first["launches_by_rank"] = [results[r]["launches"] for r in range(n_devices)]
    losses, row = first["losses"], first["row"]
    for rank, res in results.items():
        # the device metrics are the global batch's: the same on every rank
        assert res["losses"] == losses, (rank, res["losses"], losses)
        assert res["row"]["hitrate_at_n"] == row["hitrate_at_n"], rank
        np.testing.assert_array_equal(res["buffer_ids"], first["buffer_ids"])
    assert np.isfinite(losses).all(), losses
    assert np.isfinite(row["hitrate_at_n"])
    # the device tier against rank 0's host tier
    assert abs(row["hitrate_at_n"] - row["hitrate_at_n_chameleon"]) < 1e-9, row
    # the restored unit (parameters, Adam, stream, generator) replays the hour
    assert abs(losses[3] - losses[2]) < 1e-6, losses
    dp, model_par = layout(n_devices)
    if model_par > 1:
        assert "item_clicked_embedding.weight" in first["sharded"] and first["ace_sharded"]
    print(f"dryrun_multichip OK: mesh=({dp} data x {model_par} model) over "
          f"{backend}, compaction {dryrun_config(dp).train_valid_row_capacity} rows x "
          f"{dp} groups, loss={losses[1]:.4f}, eval HR@3={row['hitrate_at_n']:.4f}, "
          f"checkpoint replay dloss={abs(losses[3] - losses[2]):.2e}, row-sharded "
          f"{first['sharded']}, collectives on rank 0 {first['collectives']}")
    return first


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=4)
    p.add_argument("--platform", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--backend", default="", choices=("", "gloo", "nccl"))
    args = p.parse_args(argv)
    dryrun_multichip(args.devices, args.platform, args.backend)


if __name__ == "__main__":
    main()
