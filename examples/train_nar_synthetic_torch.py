"""The PyTorch port's quality example on a learnable synthetic stream:
``chameleon_recsys_tpu_torch.cli.train_nar_synthetic``, with the flags of
``examples/train_nar_synthetic.py``.  Runs on the card unless
``--platform cpu`` is given.

  python examples/train_nar_synthetic_torch.py --platform cpu --hours 6
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chameleon_recsys_tpu_torch.cli.train_nar_synthetic import main  # noqa: E402

if __name__ == "__main__":
    main()
