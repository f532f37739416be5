from repro_torch.serving.request import Request, latency_table, percentile
from repro_torch.serving.engine import RagdollEngine
from repro_torch.serving.generator import (ContinuousGenerator,
                                           GeneratorConfig, SlotRef,
                                           SlotTable, StaleSlotError)
from repro_torch.serving.kvpool import PagedKVCache, PageExhausted, PagePool
from repro_torch.serving.reqsched import RequestScheduler

__all__ = ["Request", "latency_table", "percentile", "RagdollEngine",
           "GeneratorConfig", "ContinuousGenerator", "SlotTable", "SlotRef",
           "StaleSlotError", "PagePool", "PagedKVCache", "PageExhausted",
           "RequestScheduler"]
