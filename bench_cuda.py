"""Headline benchmark of the PyTorch port: input bytes/sec/chip to a full
suffix array on one CUDA card, under ``bench.py``'s metric names.

    python bench_cuda.py                 # on the card (default --device cuda)
    python bench_cuda.py --device cpu    # the same program on the CPU

Prints one JSON line on stdout and the secondary metrics on stderr; the
program is ``hpc_suffix_array_tpu_torch/bench/headline.py``.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from hpc_suffix_array_tpu_torch.bench.headline import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
