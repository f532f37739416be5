from repro_torch.serving.request import Request, latency_table, percentile
from repro_torch.serving.engine import RagdollEngine, SerialRAGEngine
from repro_torch.serving.generator import (ContinuousGenerator, Generator,
                                           GeneratorConfig, SlotRef,
                                           SlotTable, StaleSlotError)
from repro_torch.serving.kvpool import (HostPagePool, PagedKVCache,
                                        PageExhausted, PagePool)
from repro_torch.serving.prefixcache import PrefixCache, PrefixCacheStats
from repro_torch.serving.reqsched import RequestScheduler
from repro_torch.serving.simulator import (ServingSimulator, SimConfig,
                                           poisson_workload)

__all__ = ["Request", "latency_table", "percentile", "RagdollEngine",
           "SerialRAGEngine", "ServingSimulator", "SimConfig",
           "poisson_workload", "GeneratorConfig", "Generator",
           "ContinuousGenerator", "SlotTable", "SlotRef",
           "StaleSlotError", "PagePool", "PagedKVCache", "HostPagePool",
           "PageExhausted", "PrefixCache", "PrefixCacheStats",
           "RequestScheduler"]
