"""Paper *quality* metrics, re-exported under the observability roof.

The runtime registry (:mod:`repro_torch.obs.registry`) measures *how
fast and at what cost* the system runs; this module is the other axis
— *how well it matches*: precision/recall/F1 against ground truth and
the §2.2.1 soundness/completeness framework properties.  The
implementation lives in :mod:`repro_torch.core.metrics`; this alias
reports quality numbers through the same ``repro_torch.obs`` surface as
the runtime ones, so ``metrics`` does not name two different things at
one import depth.
"""

from repro_torch.core.metrics import (  # noqa: F401
    PRF,
    completeness,
    prf,
    soundness,
    true_pair_gids,
)

__all__ = ["PRF", "completeness", "prf", "soundness", "true_pair_gids"]
