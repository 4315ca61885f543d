"""Serving: the asyncio continuous-batching retrieval server, its sync
facade, the fault-tolerant serving controllers and the live-index
session (the counterpart of ``repro.serving``)."""

from repro_torch.serving.client import drive  # noqa: F401
from repro_torch.serving.live import LiveIndexSession  # noqa: F401
from repro_torch.serving.resilience import (DeadlineExceeded,  # noqa: F401
                                            DegradationController,
                                            DispatcherFailed, FaultInjected,
                                            FaultInjector, Overloaded,
                                            ResilienceConfig)
from repro_torch.serving.server import (AsyncRetrievalServer,  # noqa: F401
                                        RetrievalServer, ServeConfig,
                                        ServerClosed, Served, padding_ladder)
