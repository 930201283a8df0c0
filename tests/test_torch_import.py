"""The port stands alone: importing it loads neither JAX nor the JAX package,
and no source of the port names either.  Its native libraries are its own
builds: loading them maps no file of the JAX package."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "chameleon_recsys_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "train_nar_synthetic_torch.py"
]
CUDA_SOURCES = sorted((ROOT / "chameleon_recsys_tpu_torch" / "csrc").glob("*.cu"))

_CHECK = """
import sys
import chameleon_recsys_tpu_torch
import chameleon_recsys_tpu_torch.convert
import chameleon_recsys_tpu_torch.data.synthetic
import chameleon_recsys_tpu_torch.train.steps
import chameleon_recsys_tpu_torch.train.loss
import chameleon_recsys_tpu_torch.ops.embedding
import chameleon_recsys_tpu_torch.ops.kernels.cand_scorer
import chameleon_recsys_tpu_torch.ops.kernels.ugrnn
import chameleon_recsys_tpu_torch.train.temporal
import chameleon_recsys_tpu_torch.train.checkpoint
import chameleon_recsys_tpu_torch.metrics
import chameleon_recsys_tpu_torch.baselines
import chameleon_recsys_tpu_torch.state.host_state
import chameleon_recsys_tpu_torch.utils.io
import chameleon_recsys_tpu_torch.utils.profiling
import chameleon_recsys_tpu_torch.utils.summary
import chameleon_recsys_tpu_torch.utils.artifact_store
import chameleon_recsys_tpu_torch.data.sessions
import chameleon_recsys_tpu_torch.data.pseudo_g1
import chameleon_recsys_tpu_torch.data.preprocessing
import chameleon_recsys_tpu_torch.cli.make_pseudo_g1
import chameleon_recsys_tpu_torch.cli.nar_preprocess_gcom
import chameleon_recsys_tpu_torch.cli.nar_trainer_gcom
import chameleon_recsys_tpu_torch.acr
import chameleon_recsys_tpu_torch.acr.trainer
import chameleon_recsys_tpu_torch.models.acr
import chameleon_recsys_tpu_torch.ops.rnn
import chameleon_recsys_tpu_torch.data.pseudo_adressa
import chameleon_recsys_tpu_torch.data.preprocessing.tokenization
import chameleon_recsys_tpu_torch.data.preprocessing.word_embeddings
import chameleon_recsys_tpu_torch.data.preprocessing.sessionization
import chameleon_recsys_tpu_torch.data.preprocessing.user_agent
import chameleon_recsys_tpu_torch.cli.make_pseudo_adressa
import chameleon_recsys_tpu_torch.cli.acr_preprocess_gcom
import chameleon_recsys_tpu_torch.cli.acr_preprocess_adressa
import chameleon_recsys_tpu_torch.cli.acr_trainer_adressa
import chameleon_recsys_tpu_torch.cli.nar_preprocess_adressa
import chameleon_recsys_tpu_torch.cli.nar_trainer_adressa
import chameleon_recsys_tpu_torch.ops.dropout
import chameleon_recsys_tpu_torch.train.sweep
import chameleon_recsys_tpu_torch.acr.ace_baselines
import chameleon_recsys_tpu_torch.cli.acr_trainer_gcom
import chameleon_recsys_tpu_torch.cli.ace_baselines_cli
import chameleon_recsys_tpu_torch.cli.nar_hypertuning_gcom
import chameleon_recsys_tpu_torch.baselines.gru4rec
import chameleon_recsys_tpu_torch.baselines.sr_gnn
import chameleon_recsys_tpu_torch.baselines.neural_runner
import chameleon_recsys_tpu_torch.cli.run_gru4rec
import chameleon_recsys_tpu_torch.cli.run_sr_gnn
import chameleon_recsys_tpu_torch.native
import chameleon_recsys_tpu_torch.native.build
import chameleon_recsys_tpu_torch.native.loader
import chameleon_recsys_tpu_torch.native.sknn
import chameleon_recsys_tpu_torch.parallel
import chameleon_recsys_tpu_torch.parallel.mesh
import chameleon_recsys_tpu_torch.parallel.distributed
import chameleon_recsys_tpu_torch.parallel.sharded
import chameleon_recsys_tpu_torch.parallel.dryrun
import chameleon_recsys_tpu_torch.cli.train_nar_synthetic
import runpy
runpy.run_path("examples/train_nar_synthetic_torch.py", run_name="imported")
# the native libraries: built from the port's own sources and loaded
assert chameleon_recsys_tpu_torch.native.sknn.native_available()
assert chameleon_recsys_tpu_torch.native.loader.native_available()
loaded = [m for m in sys.modules
          if m == "chameleon_recsys_tpu" or m.startswith("chameleon_recsys_tpu.")]
jax = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")]
files = [m.__file__ for m in list(sys.modules.values()) if getattr(m, "__file__", None)]
maps = open("/proc/self/maps").read()
print(loaded, jax)
assert not loaded, loaded
assert "jax" not in sys.modules and not jax, jax
# no file of the JAX package: no module, and no library (its .so files)
assert not [f for f in files if "chameleon_recsys_tpu/" in f]
assert "chameleon_recsys_tpu/" not in maps
assert "chameleon_recsys_tpu_torch/_build/libsknn-" in maps
assert "chameleon_recsys_tpu_torch/_build/libchio-" in maps
"""


def test_import_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|chameleon_recsys_tpu)\b"
)


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_sources_import_nothing_of_jax(path):
    for number, line in enumerate(path.read_text().splitlines(), 1):
        assert not _FORBIDDEN.search(line), f"{path.name}:{number}: {line}"


def test_every_cuda_source_has_a_wrapper_that_builds_it():
    """Each ``csrc/*.cu`` is named by a kernel wrapper (so that it is built and
    launched), and the kernels are the four of the ported paths."""
    names = {p.stem for p in CUDA_SOURCES}
    assert names == {"ugrnn_fwd", "ugrnn_bwd", "cand_score_fwd", "cand_score_bwd"}
    wrappers = "".join(
        (ROOT / "chameleon_recsys_tpu_torch" / "ops" / "kernels" / f).read_text()
        for f in ("ugrnn.py", "cand_scorer.py")
    )
    for name in names:
        assert f'"{name}"' in wrappers, name


@pytest.mark.parametrize("path", CUDA_SOURCES, ids=lambda p: p.name)
def test_cuda_sources_name_the_tpu_kernel_they_replace(path):
    text = path.read_text()
    assert "Replaces the TPU kernel chameleon_recsys_tpu/ops/pallas/" in text
    assert "sm_90a" in text and 'extern "C"' in text
