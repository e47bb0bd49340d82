"""The ``ngram_sim`` kernel: wrapper and plain version in ``ops``."""
