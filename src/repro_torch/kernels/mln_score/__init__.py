"""The ``mln_score`` kernel: wrapper and plain version in ``ops``."""
