"""``python -m sitator_tpu_torch`` — see :mod:`sitator_tpu_torch.cli`."""
import sys

from sitator_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
