"""SR-GNN standalone temporal runner CLI.

The port's copy of ``chameleon_recsys_tpu/cli/run_sr_gnn.py`` (twin of
nar_module/nar/benchmarks/sr-gnn/run_sr_gnn.py:1-189): ``run_gru4rec``'s
protocol and flags (``--platform`` included) with the session-graph model
and per-click prefix evaluation, and its own model flags.

  python -m chameleon_recsys_tpu_torch.cli.run_sr_gnn \
    --train_set_path_regex "sessions/sessions_hour_*.tfrecord.gz" \
    --num_items 46033 --output_csv sr_gnn_metrics.csv
"""
from __future__ import annotations

from ..baselines.sr_gnn import SRGNN, SRGNNSessionAdapter
from .run_gru4rec import build_parser, run_from_args


def main(argv=None):
    p = build_parser()
    p.add_argument("--hidden_size", type=int, default=100)
    p.add_argument("--gnn_steps", type=int, default=1)
    p.add_argument("--l2", type=float, default=1e-5)
    p.add_argument("--lr", type=float, default=1e-3)
    args = p.parse_args(argv)

    def factory(a, device):
        return SRGNNSessionAdapter(
            SRGNN(
                a.num_items,
                hidden_size=a.hidden_size,
                steps=a.gnn_steps,
                lr=a.lr,
                l2=a.l2,
                device=device,
            ),
            n_sample=a.n_sample,
        )

    run_from_args(args, model_factory=factory)


if __name__ == "__main__":
    main()
