"""The ``minhash`` kernel: wrapper and plain version in ``ops``."""
