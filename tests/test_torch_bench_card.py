"""The measurement path on a CUDA card (every case is marked ``cuda`` and
skips without one). This file imports only the port, numpy and torch,
so it collects on a machine without pandas.

``run_benchmark`` on the card must give the CPU run's integers (tolerance
none); the card's corpus generator is pinned to the bytes the recorded
measurements were taken on.
"""

import hashlib

import pytest
import torch

import hpc_suffix_array_tpu_torch.bench.timing as ttiming
import hpc_suffix_array_tpu_torch.datasets.generate as tgen

FAMILIES = {
    "random": tgen.generate_random_text,
    "dna": tgen.generate_dna_text,
    "p1000": tgen.generate_repetitive_text,
    "words": tgen.generate_words_text,
}
# device_random_text(n, 0, "cuda"): the first 64 bytes and the MD5 of
# 2^20 bytes.
CARD_ALNUM_HEAD = (
    b"7NnShMdx2Z85QQKIGj6Vorj5YFM0x3mxiDOoOTmK8c9wa1HdG7pnP5mmlfnpHJ7J")
CARD_ALNUM_MD5 = "bd5fd1ff64be0ee64f2712fedc8bd7cb"


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_benchmark_on_card_equals_cpu(family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    text = FAMILIES[family](1 << 20, seed=2)
    c = ttiming.run_benchmark(text, device="cpu", validate=True,
                              warmup=False)
    g = ttiming.run_benchmark(text, device="cuda", validate=True)
    for f in ("string_length", "lrs_length", "valid", "memory_used",
              "builder"):
        assert getattr(c, f) == getattr(g, f), f
    assert g.valid is True and g.implementation == "cuda"
    assert min(g.total_time, g.sa_time, g.lcp_time, g.lrs_time) > 0


@pytest.mark.cuda
def test_card_generators_are_pinned():
    """The corpora the card measurements were taken on (seed 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pins the CUDA generator's stream")
    a = tgen.device_random_text(1 << 20, 0, "cuda").cpu().numpy()
    assert a[:64].tobytes() == CARD_ALNUM_HEAD
    assert hashlib.md5(a.tobytes()).hexdigest() == CARD_ALNUM_MD5
    big = tgen.device_random_text((1 << 28) + 5, 1, "cuda")
    assert big.shape == ((1 << 28) + 5,) and big.dtype == torch.uint8
