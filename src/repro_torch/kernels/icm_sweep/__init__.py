"""The ``icm_sweep`` kernel: wrapper and plain version in ``ops``."""
