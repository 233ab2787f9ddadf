"""``python -m desire_tpu_torch.train``: the training entry point
(``train/run.py``)."""

import sys

from desire_tpu_torch.train.run import main

if __name__ == "__main__":
    sys.exit(main())
