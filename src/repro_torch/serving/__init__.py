"""Serving stack of the port: paged-KV engine, scheduler, speculation,
KV transfer."""
from repro_torch.serving.batch import (BatchEngine, BatchStats,  # noqa: F401
                                       RaggedBatch, TileMap, build_tile_map)
from repro_torch.serving.blocks import (BlockAllocator,  # noqa: F401
                                        KVCacheManager, NULL_BLOCK,
                                        chain_digest)
from repro_torch.serving.engine import (DecodeEngine,  # noqa: F401
                                        PagedDecodeEngine,
                                        ShardedDecodeEngine,
                                        SlotDecodeEngine)
from repro_torch.serving.scheduler import (Request, RequestState,  # noqa: F401
                                           Scheduler, SchedulerConfig,
                                           StepDecision)
from repro_torch.serving.spec import NgramProposer, Proposer  # noqa: F401
from repro_torch.serving.transfer import (DisaggregatedEngine,  # noqa: F401
                                          KVBlockRecord, KVShipment,
                                          TransferIntegrityError,
                                          edge_dc_topology, payload_checksum)
