"""The ``flash_attn`` kernel: wrapper and plain version in ``ops``."""
