"""``python -m hpc_suffix_array_tpu_torch``: the command line of
``cli.py`` (runs on the card unless given ``--device cpu``)."""

import sys

from hpc_suffix_array_tpu_torch.cli import main

sys.exit(main())
