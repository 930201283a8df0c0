"""The port stands alone: importing it loads neither JAX nor the JAX package,
and no source of the port names either."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "chameleon_recsys_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
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
loaded = [m for m in sys.modules
          if m == "chameleon_recsys_tpu" or m.startswith("chameleon_recsys_tpu.")]
jax = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")]
print(loaded, jax)
assert not loaded, loaded
assert "jax" not in sys.modules and not jax, jax
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
