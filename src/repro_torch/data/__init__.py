from repro_torch.data.pipeline import (
    ExpertWorkload,
    drifting_workload,
    lm_batches,
    markov_lm,
    workload_from_paper_stats,
)

__all__ = ["ExpertWorkload", "drifting_workload", "lm_batches", "markov_lm",
           "workload_from_paper_stats"]
