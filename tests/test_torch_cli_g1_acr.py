"""The port's G1 ACR CLIs and the ACE-baselines CLI against the JAX
package's, on the CPU, over ``tests/test_cli_pipeline.py``'s tiny raw
fixture (30 articles in 5 categories, a 60-word 8-dim word2vec file).

* ``acr_preprocess_gcom``: the article TFRecords (gzip's mtime zeroed, as
  ``tests/test_torch_cli_g1.py`` compares them), the vocabulary/embedding
  pickle and the label-encoder pickle byte-equal to the JAX CLI's;
* ``acr_trainer_gcom`` for both tasks (the CNN classifier; the GRU
  autoencoder without noise, two layers), the port's trainer loading the
  JAX trainer's initial weights: the exported pickles' encoders and
  metadata equal and the ACE matrices within 1e-4 (``tests/test_torch_acr.py``'s
  fit tolerance); the autoencoder again with noise and dropout, for the
  contract only (their draws differ between the packages);
* ``ace_baselines_cli`` for each method: the handoff pickle's contract
  (flat encoders, the metadata columns, [articles + 1, dim] with the mean
  in row 0), LSA and W2V-TF-IDF within 1e-5 of the JAX CLI's (deterministic
  given the seed), doc2vec with its own initial draw.
"""
import gzip
import pickle
from pathlib import Path

import numpy as np
import pytest

from chameleon_recsys_tpu.acr import trainer as jax_acr_trainer_module
from chameleon_recsys_tpu.cli import ace_baselines_cli as jax_ace_cli
from chameleon_recsys_tpu.cli import acr_preprocess_gcom as jax_preprocess
from chameleon_recsys_tpu.cli import acr_trainer_gcom as jax_trainer

from chameleon_recsys_tpu_torch.cli import ace_baselines_cli, acr_preprocess_gcom, acr_trainer_gcom
from chameleon_recsys_tpu_torch.convert import acr_params_from_flax

from test_cli_pipeline import raw_data  # noqa: F401  (the tiny raw fixture)
from test_torch_acr import numpy_tree

TOKENS = "16"
TASKS = {
    "classifier": ["--text_feature_extractor", "CNN", "--cnn_num_filters", "8",
                   "--acr_embeddings_size", "10"],
    "autoencoder": ["--training_task", "autoencoder", "--text_feature_extractor", "GRU",
                    "--rnn_units", "12", "--rnn_layers", "2", "--acr_embeddings_size", "10"],
}
COMMON = ["--batch_size", "8", "--training_epochs", "2", "--learning_rate", "3e-3",
          "--l2_reg_lambda", "1e-4", "--truncate_tokens_length", TOKENS]


def preprocess(raw: Path, out: Path, cli):
    cli.main(["--input_articles_csv_path", str(raw / "articles.csv"),
              "--input_word_embeddings_path", str(raw / "w2v.txt"),
              "--output_dir", str(out), "--truncate_tokens_length", TOKENS,
              "--first_sentences", "4", "--platform", "cpu"])


def inputs(pre: Path):
    return ["--train_set_path_regex", str(pre / "articles_tokenized_*.tfrecord.gz"),
            "--input_word_vocab_embeddings_path", str(pre / "acr_word_vocab_embeddings.pickle"),
            "--input_label_encoders_path", str(pre / "acr_label_encoders.pickle")]


@pytest.fixture(scope="module")
def runs(raw_data, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("cli_g1_acr")
    preprocess(raw_data, root / "jax" / "pre", jax_preprocess)
    preprocess(raw_data, root / "port" / "pre", acr_preprocess_gcom)
    captured = {}

    class RecordingJaxACRTrainer(jax_acr_trainer_module.ACRTrainer):
        def init(self, example_batch):
            super().init(example_batch)
            captured["params"] = numpy_tree(self.params)

    class InjectedPortACRTrainer(acr_trainer_gcom.ACRTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.model.load_state_dict(acr_params_from_flax(captured["params"], self.model))

    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("CHAMELEON_JAX_CACHE", "")  # no compile cache outside the run
        patch.setattr(jax_trainer, "ACRTrainer", RecordingJaxACRTrainer)
        patch.setattr(acr_trainer_gcom, "ACRTrainer", InjectedPortACRTrainer)
        for task, flags in TASKS.items():
            for side, cli in (("jax", jax_trainer), ("port", acr_trainer_gcom)):
                cli.main(inputs(root / "jax" / "pre") + COMMON + flags + [
                    "--output_acr_metadata_embeddings_path", str(root / side / f"{task}.pkl"),
                    "--platform", "cpu"])
    return root


def gzip_without_mtime(data: bytes) -> bytes:
    assert data[:2] == b"\x1f\x8b"
    return data[:4] + b"\0\0\0\0" + data[8:]


def test_preprocessing_outputs_byte_equal(runs):
    names = sorted(p.name for p in (runs / "port" / "pre").iterdir())
    assert names == sorted(p.name for p in (runs / "jax" / "pre").iterdir())
    assert names == ["acr_label_encoders.pickle", "acr_word_vocab_embeddings.pickle",
                     "articles_tokenized_0000.tfrecord.gz"]
    for name in names:
        port_bytes, jax_bytes = ((runs / side / "pre" / name).read_bytes()
                                 for side in ("port", "jax"))
        if name.endswith(".gz"):
            assert len(gzip.decompress(port_bytes)) > 0
            port_bytes, jax_bytes = gzip_without_mtime(port_bytes), gzip_without_mtime(jax_bytes)
        assert port_bytes == jax_bytes, name


@pytest.mark.parametrize("task", list(TASKS))
def test_acr_trainer_gcom_matches_jax(runs, task):
    port_enc, port_meta, port_ace = pickle.loads((runs / "port" / f"{task}.pkl").read_bytes())
    jax_enc, jax_meta, jax_ace = pickle.loads((runs / "jax" / f"{task}.pkl").read_bytes())
    assert port_enc == jax_enc and list(port_meta) == list(jax_meta)
    for key in jax_meta:
        np.testing.assert_array_equal(port_meta[key], jax_meta[key])
    assert port_ace.shape == jax_ace.shape == (31, 10) and port_ace.dtype == np.float32
    np.testing.assert_allclose(port_ace, jax_ace, rtol=0, atol=1e-4)
    np.testing.assert_allclose(port_ace[0], port_ace[1:].mean(axis=0), atol=1e-6)


def test_autoencoder_with_noise_and_dropout_runs(runs, tmp_path):
    out = tmp_path / "ae.pkl"
    acr_trainer_gcom.main(inputs(runs / "port" / "pre") + COMMON + TASKS["autoencoder"] + [
        "--autoencoder_noise", "0.05", "--dropout_keep_prob", "0.8",
        "--output_acr_metadata_embeddings_path", str(out), "--platform", "cpu"])
    enc, meta, ace = pickle.loads(out.read_bytes())
    jax_enc, jax_meta, _ = pickle.loads((runs / "jax" / "autoencoder.pkl").read_bytes())
    assert enc == jax_enc and list(meta) == list(jax_meta)
    assert ace.shape == (31, 10) and np.isfinite(ace).all()
    np.testing.assert_allclose(ace[0], ace[1:].mean(axis=0), atol=1e-6)


@pytest.mark.parametrize("method,dim", [("lsa", 10), ("w2v_tfidf", None), ("doc2vec", 8)])
def test_ace_baselines_cli(runs, tmp_path, method, dim):
    def run(cli, out):
        argv = inputs(runs / "jax" / "pre") + [
            "--method", method, "--output_acr_metadata_embeddings_path", str(out),
            "--truncate_tokens_length", TOKENS, "--training_epochs", "2",
            "--platform", "cpu"]
        cli.main(argv + ([] if dim is None else ["--acr_embeddings_size", str(dim)]))
        return pickle.loads(out.read_bytes())

    encoders, metadata, ace = run(ace_baselines_cli, tmp_path / "port.pkl")
    jax_encoders, jax_metadata, jax_ace = run(jax_ace_cli, tmp_path / "jax.pkl")
    assert encoders == jax_encoders and set(encoders) == {"category_id", "article_id"}
    assert list(metadata) == list(jax_metadata)
    for key in jax_metadata:
        np.testing.assert_array_equal(metadata[key], jax_metadata[key])
    assert ace.shape == (31, dim or 8) and ace.dtype == np.float32 and np.isfinite(ace).all()
    np.testing.assert_allclose(ace[0], ace[1:].mean(axis=0), atol=1e-6)
    if method != "doc2vec":
        np.testing.assert_allclose(ace, jax_ace, rtol=0, atol=1e-5)
