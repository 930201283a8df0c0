#!/usr/bin/env python3
"""How far the port's training on the card drifts from the same training on
the CPU: the readings that ``tests/test_torch_cuda.py``'s ACR and Adressa
tolerances are set from.

    python3 scripts/card_cpu_drift.py

1. ACR, at the corpus and widths of ``test_acr_train_steps_on_card_match_cpu``
   (160 articles of 40 tokens, 32-dim words, ACE 24, 16 RNN units, batch 8,
   lr 1e-3, 20 steps): for the CNN, the GRU and the LSTM (each direction),
   from the same weights on the CPU and on the card, the largest ACE
   difference at the initial weights, the first step's gradients (the worst
   parameter, ||card - cpu|| / ||cpu||), and after the 20 Adam steps the
   largest ACE difference and the worst parameter; with TF32 off (the
   trainer's setting), with TF32 on (the trainer's switch bypassed), and
   with cuDNN off (torch's own CUDA kernels).
2. The Adressa NAR trainer CLI over a small pseudo-Adressa stream (3 hours,
   300 articles, 100 sessions an hour, seed 11; ACEs from the ACR CLI on the
   CPU), float32 at ``test_adressa_chain_on_card_matches_cpu``'s widths, on
   the CPU and on the card from the same weights and sampler uniforms: the
   largest probability difference of steps whose ranked ids agree, and the
   CPU's probability gap at each ranked position where they differ.

Needs a card; prints one line per case.
"""
from __future__ import annotations

import contextlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chameleon_recsys_tpu_torch.acr import trainer as acr_trainer  # noqa: E402
from chameleon_recsys_tpu_torch.config import ACRConfig  # noqa: E402
from chameleon_recsys_tpu_torch.models.acr import ACRLabelSpec  # noqa: E402
from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms  # noqa: E402


def acr_corpus(seed=0, n=160, vocab=300, dim=32, length=40):
    """``tests/test_torch_cuda.py::_acr_corpus``."""
    rng = np.random.RandomState(seed)
    word_emb = (rng.randn(vocab, dim) * 0.3).astype(np.float32)
    lengths = rng.randint(8, length + 1, n)
    text = np.where(np.arange(length)[None] < lengths[:, None],
                    rng.randint(2, vocab, (n, length)), 0).astype(np.int32)
    articles = {"article_id": np.arange(1, n + 1), "text": text,
                "text_length": lengths.astype(np.int32),
                "category0": rng.randint(1, 12, n), "keywords": rng.randint(0, 20, (n, 4))}
    return word_emb, articles, {"category0": (rng.rand(12) + 0.5).astype(np.float32)}


@contextlib.contextmanager
def tf32_on():
    """TF32 on for the steps: the trainer's switch replaced by one that
    leaves both flags on."""
    saved = acr_trainer._full_f32
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    acr_trainer._full_f32 = contextlib.nullcontext
    try:
        yield
    finally:
        acr_trainer._full_f32 = saved
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@contextlib.contextmanager
def cudnn_off():
    with torch.backends.cudnn.flags(enabled=False):
        yield


def acr_run(cfg, device):
    """(initial ACE, first-step gradients, ACE and state after the epoch)."""
    word_emb, articles, class_weights = acr_corpus()
    specs = (ACRLabelSpec("category0", 12, "multiclass"),
             ACRLabelSpec("keywords", 20, "multilabel"))

    class Recording(acr_trainer.ACRTrainer):
        def train_step(self, batch, weights):
            out = super().train_step(batch, weights)
            if not hasattr(self, "grads"):
                self.grads = {n: p.grad.detach().cpu() for n, p in self.model.named_parameters()}
            return out

    trainer = Recording(cfg, word_emb, specs, class_weights, device=device)
    initial = trainer.predict_all_ace(articles)
    trainer.fit(articles)
    state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()
             if k != "word_embeddings"}
    return initial, trainer.grads, trainer.predict_all_ace(articles), state


def worst(card, cpu):
    return max(float((card[k] - v).norm() / v.norm().clamp(min=1e-30)) for k, v in cpu.items())


def acr_part():
    for extractor, direction in (("CNN", "unidirectional"), ("GRU", "bidirectional"),
                                 ("LSTM", "unidirectional"), ("LSTM", "bidirectional")):
        cfg = ACRConfig(text_feature_extractor=extractor, rnn_direction=direction,
                        word_embedding_size=32, vocab_size=300, truncate_tokens_length=40,
                        acr_embeddings_size=24, rnn_units=16, batch_size=8,
                        training_epochs=1, learning_rate=1e-3, l2_reg_lambda=1e-5)
        cpu = acr_run(cfg, "cpu")
        for label, setting in (("TF32 off", contextlib.nullcontext), ("TF32 on", tf32_on),
                               ("cuDNN off", cudnn_off)):
            with setting():
                card = acr_run(cfg, "cuda")
            print(f"acr {extractor} {direction} {label}: initial ACE "
                  f"{np.abs(card[0] - cpu[0]).max():.3e}, first-step gradients "
                  f"{worst(card[1], cpu[1]):.3e}, after 20 steps ACE "
                  f"{np.abs(card[2] - cpu[2]).max():.3e}, parameters {worst(card[3], cpu[3]):.3e}",
                  flush=True)


def nar_part(workdir: Path):
    from chameleon_recsys_tpu_torch.cli import (
        acr_preprocess_adressa,
        acr_trainer_adressa,
        make_pseudo_adressa,
        nar_preprocess_adressa,
        nar_trainer_adressa,
    )
    from chameleon_recsys_tpu_torch.train import steps, temporal

    make_pseudo_adressa.main(["--output_dir", str(workdir / "bundle"), "--hours", "3",
                              "--num_articles", "300", "--sessions_per_hour", "100",
                              "--seed", "11", "--quiet"])
    acr_preprocess_adressa.main([
        "--input_articles_json_path", str(workdir / "bundle" / "articles.jsonl"),
        "--input_word_embeddings_path", str(workdir / "bundle" / "w2v.txt"),
        "--output_dir", str(workdir / "acr"), "--truncate_tokens_length", "40",
        "--min_label_freq", "1"])
    acr_trainer_adressa.main([
        "--train_set_path_regex", str(workdir / "acr" / "articles_tokenized_*.tfrecord.gz"),
        "--input_word_vocab_embeddings_path", str(workdir / "acr" / "acr_word_vocab_embeddings.pickle"),
        "--input_label_encoders_path", str(workdir / "acr" / "acr_label_encoders.pickle"),
        "--output_acr_metadata_embeddings_path", str(workdir / "ace.pickle"),
        "--text_feature_extractor", "CNN", "--acr_embeddings_size", "16", "--batch_size", "8",
        "--training_epochs", "1", "--truncate_tokens_length", "40", "--platform", "cpu"])
    nar_preprocess_adressa.main([
        "--input_clicks_json_path", str(workdir / "bundle" / "clicks.jsonl"),
        "--output_sessions_tfrecords_path", str(workdir / "s" / "sessions_hour_*.tfrecord.gz"),
        "--output_nar_preprocessing_resources_path", str(workdir / "resources.pickle")])
    b, length, buffer, factor = 8, 6, 64, 20
    logs = {}
    for platform in ("cpu", "cuda"):
        rng = np.random.RandomState(5)

        def draw(device):
            nc = min(3 * factor, b * length + 16)
            return SamplerUniforms(*(
                torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(device)
                for shape in ((buffer,), (b * length + 16,), (b, length, nc))))

        saved = temporal.train_step, temporal.eval_step
        temporal.train_step = lambda state, batch, ace, meta, **kw: steps.train_step(
            state, batch, ace, meta, uniforms=draw(ace.device), **kw)
        temporal.eval_step = lambda model, stream, batch, ace, meta, **kw: steps.eval_step(
            model, stream, batch, ace, meta, uniforms=draw(ace.device), **kw)
        try:
            model_dir = workdir / f"model_{platform}"
            nar_trainer_adressa.main([
                "--train_set_path_regex", str(workdir / "s" / "sessions_hour_*.tfrecord.gz"),
                "--acr_module_resources_path", str(workdir / "ace.pickle"),
                "--nar_module_preprocessing_resources_path", str(workdir / "resources.pickle"),
                "--model_dir", str(model_dir), "--training_hours_for_each_eval", "1",
                "--batch_size", str(b), "--truncate_session_length", str(length),
                "--CAR_embedding_size", "16", "--rnn_units", "10",
                "--train_total_negative_samples", "3",
                "--train_negative_samples_from_buffer", "16",
                "--eval_total_negative_samples", "3", "--eval_negative_samples_from_buffer", "16",
                "--eval_metrics_top_n", "3", "--recent_clicks_buffer_max_size", str(buffer),
                "--recent_clicks_for_normalization", "32", "--compute_dtype", "float32",
                "--save_eval_sessions_recommendations", "--disable_eval_benchmarks",
                "--platform", platform])
        finally:
            temporal.train_step, temporal.eval_step = saved
        logs[platform] = [json.loads(line) for line in (
            model_dir / "eval_chameleon_recommendations_log.json").read_text().splitlines()]
    agree, gaps, steps_compared = 0.0, [], 0
    for card_rec, cpu_rec in zip(logs["cuda"], logs["cpu"]):
        for c_ids, p_ids, c_probs, p_probs in zip(
                card_rec["predicted_item_ids"], cpu_rec["predicted_item_ids"],
                card_rec["predicted_item_probs"], cpu_rec["predicted_item_probs"]):
            steps_compared += 1
            differ = np.flatnonzero(np.asarray(c_ids) != np.asarray(p_ids))
            if not differ.size:
                agree = max(agree, float(np.max(np.abs(np.subtract(c_probs, p_probs)))))
            gaps += [min(abs(p_probs[i] - p_probs[q]) for q in (i - 1, i + 1)
                         if 0 <= q < len(p_probs)) for i in differ]
    print(f"nar adressa cli: {steps_compared} ranked steps; largest |probability difference| "
          f"where the ids agree {agree:.3e}; {len(gaps)} ranked positions differ, the CPU's "
          f"gaps there {sorted(round(g, 8) for g in gaps)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("card_cpu_drift: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    acr_part()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".card_cpu_drift_") as workdir:
        nar_part(Path(workdir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
