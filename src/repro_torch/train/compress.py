"""Cross-pod gradient compression: int8 quantized all-reduce with error feedback.

The compressed exchange reduces gradients across pods of a device mesh,
so it waits for the multi-device slice (``ROADMAP.md`` Queue 1 item 15):
each function raises until then.
"""

from __future__ import annotations

from repro_torch.models.param import unported_fn

quantize = unported_fn("quantize", item=15)
compressed_psum = unported_fn("compressed_psum", item=15)
tree_compressed_psum = unported_fn("tree_compressed_psum", item=15)
init_error_state = unported_fn("init_error_state", item=15)
