from repro_torch.core.cache_policies import POLICIES, LearnedPolicy, make_policy
from repro_torch.core.costmodel import CostModel, HardwareProfile, ModelBytes
from repro_torch.core.expert_cache import ExpertCache
from repro_torch.core.expert_store import ExpertStore
from repro_torch.core.learned import (LearnedModel, evaluate_recall,
                                      train_from_trace)
from repro_torch.core.memory_tiers import (SwapQueue, TieredMemoryManager,
                                           plan_hbm_split)
from repro_torch.core.offload_engine import OffloadEngine
from repro_torch.core.paged_kv import PagedKVCache
from repro_torch.core.prefetch import (LearnedPredictor, MarkovPredictor,
                                       SpeculativePrefetcher)
from repro_torch.core.trace import StepTrace, TierEvent, TraceRecorder
from repro_torch.core.transfer_engine import Transfer, TransferEngine

__all__ = [
    "POLICIES", "make_policy", "CostModel", "HardwareProfile", "ModelBytes",
    "ExpertCache", "ExpertStore", "LearnedModel", "LearnedPolicy",
    "LearnedPredictor", "OffloadEngine", "MarkovPredictor",
    "PagedKVCache", "SpeculativePrefetcher", "StepTrace", "SwapQueue",
    "TierEvent", "TieredMemoryManager", "TraceRecorder", "Transfer",
    "TransferEngine", "evaluate_recall", "train_from_trace",
    "plan_hbm_split",
]
