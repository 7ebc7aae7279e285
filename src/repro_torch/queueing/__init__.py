# Publish/subscribe control plane (paper §Method b-d): message broker with
# leases + DLQ, backlog/window autoscaler, drain workers, exactly-once journal.
from repro_torch.queueing.broker import Broker, Message, QueueStats
from repro_torch.queueing.autoscaler import Autoscaler, AutoscalerConfig, ScaleEvent
from repro_torch.queueing.journal import Journal
from repro_torch.queueing.worker import DeidWorker, WorkerPool, FailureInjector

__all__ = [
    "Broker",
    "Message",
    "QueueStats",
    "Autoscaler",
    "AutoscalerConfig",
    "ScaleEvent",
    "Journal",
    "DeidWorker",
    "WorkerPool",
    "FailureInjector",
]
