from repro_torch.serve.decode import build_serve_step, build_prefill
from repro_torch.serve.kv_cache import (BlockPool, OutOfBlocks, init_paged_pool,
                                        build_paged_decode, build_paged_prefill)
from repro_torch.serve.scheduler import Request, ServeScheduler
from repro_torch.serve.kv_transfer import (KVConnector, LinkCostedConnector,
                                           InProcessTransport,
                                           DisaggregatedScheduler)
from repro_torch.serve.handoff import (serving_weights_from_state,
                                       serving_weights_from_checkpoint)

__all__ = [
    "build_serve_step", "build_prefill",
    "BlockPool", "OutOfBlocks", "init_paged_pool",
    "build_paged_decode", "build_paged_prefill",
    "Request", "ServeScheduler",
    "KVConnector", "LinkCostedConnector", "InProcessTransport",
    "DisaggregatedScheduler",
    "serving_weights_from_state", "serving_weights_from_checkpoint",
]
