"""Corpus generators (random, repetitive, DNA, words) and fixtures."""

from hpc_suffix_array_tpu_torch.datasets.generate import (
    SMALL_FIXTURES, generate_dna_text, generate_random_text,
    generate_repetitive_text, generate_words_text)

__all__ = ["SMALL_FIXTURES", "generate_dna_text", "generate_random_text",
           "generate_repetitive_text", "generate_words_text"]
