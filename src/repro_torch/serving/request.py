"""Request lifecycle shared by the serving engines.

A ``Request`` moves through: queued -> admitted to a batch slot ->
prefill (prompt tokens stream through the shared batched decode, one
per step) -> decode (sample, feed back) -> retired (EOS / ``max_new``).
The static-batching ``ServingEngine`` uses only the prompt/output
fields; the continuous ``ContinuousOffloadServer`` drives the full
lifecycle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False

    # --- continuous-batching lifecycle (managed by the server) --------
    rid: int = -1                 # trace prompt_id, assigned at submit
    slot: int = -1                # batch row while admitted, -1 otherwise
    pos: int = 0                  # tokens fed so far == next seq position
    eos_hit: bool = False
    join_seq: int = -1            # admission order (fifo preemption
                                  # evicts the youngest joiner first)
    preemptions: int = 0          # times evicted from a paged pool and
                                  # requeued (KV rebuilt from tokens)

    # --- scheduling inputs (see repro_torch.serving.scheduler) --------------
    priority: int = 0             # higher admits first under "priority"
    tenant: Optional[str] = None  # fairness group under "priority"

    # --- robustness lifecycle (see docs/robustness.md) ----------------
    status: str = ""              # terminal: "completed"|"timeout"|"shed"
                                  # ("" while live; legacy retirements
                                  # also read as completed)
    shed_reason: str = ""         # typed reason when status != completed
                                  # ("deadline_steps", "queue_pressure",
                                  # "queue_full")
    deadline_steps: Optional[int] = None  # per-request timeout override
                                  # (server steps from submit; None ->
                                  # server default)

    # --- latency accounting (server step counter timestamps) ----------
    submit_step: int = -1         # server step count at submit()
    admit_step: int = -1          # first admission (queue wait ends)
    finish_step: int = -1         # retirement
    steps_advanced: int = 0       # engine steps that fed >=1 token of
                                  # this request (excludes queue waits
                                  # and post-preemption waiting)

    # per-request sampling (None -> server defaults)
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None

    @property
    def tokens(self) -> List[int]:
        """Everything known for this sequence: prompt + generated."""
        return self.prompt + self.out

    @property
    def in_prefill(self) -> bool:
        return self.pos < len(self.prompt)

    @property
    def catching_up(self) -> bool:
        """More than one known-but-unfed token: initial prefill, or a
        post-preemption replay. These rows are chunkable — feeding
        several of their tokens in one step changes no output."""
        return len(self.tokens) - self.pos > 1

    def total_len(self) -> int:
        return len(self.prompt) + self.max_new

    def wait_steps(self) -> int:
        """Server steps this request spent pending without advancing
        (queued behind prefill, deferred admission, preempted). Only
        meaningful after retirement."""
        if self.finish_step < 0 or self.submit_step < 0:
            return 0
        return (self.finish_step - self.submit_step) - self.steps_advanced
