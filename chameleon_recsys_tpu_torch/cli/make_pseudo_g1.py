"""Generate a full-scale pseudo-G1 bundle in the Kaggle file layout.

The port's copy of ``chameleon_recsys_tpu/cli/make_pseudo_g1.py``, with the
same flags and the same output bytes.  The real dataset is proprietary
(docs/G1_RECIPE.md points at the Kaggle download); this CLI fabricates a
news-churn stream at the same shape (46,033 articles, 385 hourly click
CSVs, ~1M sessions) so that the whole recipe (preprocess CLI -> trainer CLI
-> eval CSV) runs end to end without the download.

Usage:
  python -m chameleon_recsys_tpu_torch.cli.make_pseudo_g1 --output_dir pseudo_g1 \
      [--hours 385] [--mean_sessions_per_hour 2600] [--num_workers 4]
"""
from __future__ import annotations

import argparse
import time

from ..data.pseudo_g1 import PseudoG1Spec, write_bundle


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--hours", type=int, default=385)
    parser.add_argument("--num_articles", type=int, default=46_033)
    parser.add_argument("--mean_sessions_per_hour", type=int, default=2_600)
    parser.add_argument("--ace_dim", type=int, default=250)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--regime", choices=("legacy", "mixed"),
                        default="legacy",
                        help="'mixed' = hardened mixed-behavior stream "
                        "(category Markov hops, popularity-only sessions, "
                        "noised ACE; data/pseudo_g1.py)")
    args = parser.parse_args(argv)

    ctor = PseudoG1Spec.mixed if args.regime == "mixed" else PseudoG1Spec
    spec = ctor(
        num_articles=args.num_articles,
        ace_dim=args.ace_dim,
        hours=args.hours,
        mean_sessions_per_hour=args.mean_sessions_per_hour,
        seed=args.seed,
    )
    t0 = time.time()
    totals = write_bundle(spec, args.output_dir, num_workers=args.num_workers)
    print(
        f"pseudo-G1 bundle: {args.hours} hourly files, "
        f"{totals['clicks']} clicks, {time.time() - t0:.1f}s "
        f"-> {args.output_dir}"
    )


if __name__ == "__main__":
    main()
