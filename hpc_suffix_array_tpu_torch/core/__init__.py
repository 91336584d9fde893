"""Single-device builders: suffix array, LCP, LRS, validation, oracles."""
