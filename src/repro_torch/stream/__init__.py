"""Streaming incremental entity matching on the device.

The batch pipeline (``repro_torch.core.pipeline``) builds a total cover
once and runs message passing to a global fixpoint.  This package keeps
that fixpoint *current* under a stream of arriving entities, with
per-ingest cost proportional to the dirty set rather than the corpus.
One ``ResolveService.ingest(batch)`` runs five stages:

1. **Probe** (:mod:`repro_torch.stream.index`) — MinHash signatures on
   the device (the ``minhash`` CUDA kernel), LSH bucket collisions gate
   the exact cosine probes (the ``ngram_sim`` kernel); optionally
   memory-bounded via ``LSHConfig.max_ids`` / ``ttl_adds``.
2. **Replay** (:mod:`repro_torch.stream.delta`) — the canonical canopy
   sweep is replayed over only the touched similarity components
   (``IngestReport.replay_visits`` counts the region).
3. **Assemble + splice** (:class:`repro_torch.core.cover.CoverDelta`) —
   the total cover (Def. 7) is re-derived incrementally and the packed
   per-bin arrays are spliced instead of rebuilt
   (``IngestReport.cover_splice_rows``).
4. **Ground + advance** (:mod:`repro_torch.stream.engine`,
   :class:`repro_torch.core.global_grounding.GroundingMaintainer`) — the
   global grounding is patched and its array form spliced
   (``grounding_pair_visits`` / ``grounding_splice_rows``); the
   sequential drivers are warm-started with only the dirty
   neighborhoods seeded, and the matcher runs on the device.
5. **Commit** (:mod:`repro_torch.stream.service`) — matches fold into a
   persistent union-find, then the whole ingest publishes to readers
   in one snapshot swap.

Every ingest is transactional (``repro_torch.core.txn`` undo log: any
mid-ingest failure rolls the service back to the pre-submit state
bit-for-bit).  The service is the reference's (``repro.stream``), held
to it by :func:`repro_torch.stream.digest.state_digest` after every
ingest.  Durability (:mod:`repro_torch.stream.wal` and the
checkpointer: ``ServiceConfig.durability_dir``,
``ResolveService.recover``) and the coalescing serving front-end
(:mod:`repro_torch.stream.serving`) are the reference's too, and so is
sharded serving (:mod:`repro_torch.stream.shard`: one replica a rank of
a ``torch.distributed`` group).
"""

from repro_torch.stream.service import (
    IngestReport,
    ResolveService,
    ResolveSnapshot,
    ServiceConfig,
)
from repro_torch.stream.serving import (
    AdmissionError,
    IngestTicket,
    ServingConfig,
    ServingFrontend,
)

__all__ = [
    "AdmissionError",
    "IngestReport",
    "IngestTicket",
    "ResolveService",
    "ResolveSnapshot",
    "ServiceConfig",
    "ServingConfig",
    "ServingFrontend",
]
