"""Corpus generators (random, repetitive, DNA, words), fixtures and files."""

from hpc_suffix_array_tpu_torch.datasets.generate import (
    SMALL_FIXTURES, device_dna_text, device_random_text,
    device_repetitive_text, device_words_text, generate_dna_text,
    generate_random_text, generate_repetitive_text,
    generate_standard_datasets,
    generate_test_fixtures, generate_words_text, generate_words_text_batched)

__all__ = ["SMALL_FIXTURES", "device_dna_text", "device_random_text",
           "device_repetitive_text", "device_words_text",
           "generate_dna_text", "generate_random_text",
           "generate_repetitive_text",
           "generate_standard_datasets", "generate_test_fixtures",
           "generate_words_text", "generate_words_text_batched"]
