"""Device-transfer accounting: host→device upload bytes, by site.

The serving path has three transfer sites, each with a named counter,
all in the round-parallel engine (:mod:`repro_torch.core.parallel`);
the sequential engine has none, so ``IngestReport.upload_bytes`` reads
0 there, as it does in the reference's sequential engine:

* ``transfer.gcache_bytes`` — raw row arrays shipped to the grounding
  calls (``core.parallel.GroundingCache``: cold grounds and splices,
  pow2-padded).  O(rows re-ground), i.e. O(dirty) on the streaming
  path.
* ``transfer.promoter_bytes`` — ``DevicePromoter`` uploads: the global
  grounding's ``u``/coupling COO (once per grounding *version* — today
  O(pairs) per ingest), the pool
  group CSR (once per ``MessagePool.groups()`` snapshot), and the base
  bitset per promotion call.
* ``transfer.prepare_bytes`` — ``_prepare_bins`` staging: the padded
  per-bin host copies (the bytes later dispatches upload, counted once
  at staging time), paid once per ``run_parallel`` call.

``record_transfer`` is the single write path so the byte arithmetic
(`sum of .nbytes`) cannot drift between sites; per-ingest deltas are
read back by ``ResolveService`` (``IngestReport.upload_bytes``).
"""

from __future__ import annotations

from repro_torch.obs.registry import get_registry

__all__ = ["SITES", "record_transfer", "total_upload_bytes"]

SITES = ("gcache", "promoter", "prepare")


def record_transfer(site: str, *arrays) -> int:
    """Count host→device upload bytes against ``transfer.<site>_bytes``.

    ``arrays`` are the staged/uploaded buffers (anything with
    ``.nbytes``); returns the byte total for callers that also track
    locally.
    """
    n = sum(int(a.nbytes) for a in arrays if a is not None)
    if n:
        get_registry().counter(f"transfer.{site}_bytes").inc(n)
    return n


def total_upload_bytes() -> int:
    """Current sum over every transfer site's counter."""
    reg = get_registry()
    return sum(reg.value(f"transfer.{s}_bytes") for s in SITES)
