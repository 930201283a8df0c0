"""Generate the full-scale pseudo-Adressa raw bundle (see
data/pseudo_adressa.py): per-article JSON, a word2vec text file and a
click-log JSON, the raw inputs of the Adressa CLI chain
(acr_preprocess_adressa -> acr_trainer_adressa -> nar_preprocess_adressa ->
nar_trainer_adressa).

The port's copy of ``chameleon_recsys_tpu/cli/make_pseudo_adressa.py``,
with the same flags and the same output bytes.

Usage:
  python -m chameleon_recsys_tpu_torch.cli.make_pseudo_adressa \
      --output_dir pseudo_adressa [--hours 384] [--sessions_per_hour 2600]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from ..data.pseudo_adressa import PseudoAdressaSpec, write_bundle


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", required=True)
    p.add_argument("--hours", type=int, default=384)
    p.add_argument("--num_articles", type=int, default=13_000)
    p.add_argument("--sessions_per_hour", type=int, default=2_600)
    p.add_argument("--vocab_size", type=int, default=20_000)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--regime", choices=("legacy", "mixed"), default="legacy",
                   help="'mixed' = hardened mixed-behavior stream "
                   "(category Markov hops, popularity-only sessions; "
                   "data/pseudo_g1.py)")
    args = p.parse_args(argv)

    ctor = (PseudoAdressaSpec.mixed if args.regime == "mixed"
            else PseudoAdressaSpec)
    spec = ctor(
        num_articles=args.num_articles,
        hours=args.hours,
        mean_sessions_per_hour=args.sessions_per_hour,
        vocab_size=args.vocab_size,
        seed=args.seed,
    )
    t0 = time.time()
    totals = write_bundle(spec, args.output_dir, verbose=not args.quiet)
    totals["seconds"] = round(time.time() - t0, 1)
    totals["spec"] = dataclasses.asdict(spec)
    print(json.dumps(totals))


if __name__ == "__main__":
    main()
