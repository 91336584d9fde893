from hpc_suffix_array_tpu_torch.utils.io import (
    read_file, write_file, print_first_chars, print_last_chars)

__all__ = ["read_file", "write_file", "print_first_chars", "print_last_chars"]
