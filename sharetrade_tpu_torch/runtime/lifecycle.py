"""Lifecycle state machine — the router's four-phase protocol, actor-free.

A copy of the JAX package's ``runtime/lifecycle.py`` (it imports no JAX;
the port keeps its own copy rather than importing the JAX package).

Reference: TrainerRouterActor's ``context.become`` chain
``awaitingTrainingData → trainingDataPresent → trained → completed``
(TrainerRouterActor.scala:68-130) with the reply ADT
``NoTrainingDataReceived / NotComputed / TrainingNotCompleted / Completed /
Result(x)`` (:15-34). Here the same protocol is an explicit enum + a
``QueryReply`` value, and "stashing" ``StartTraining`` until data arrives
(:75-76) is a recorded intent flag the orchestrator honors.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass


class Phase(enum.Enum):
    AWAITING_DATA = "awaiting_data"    # awaitingTrainingData
    READY = "ready"                    # trainingDataPresent
    TRAINING = "training"              # children training (trained accumulate)
    TRAINED = "trained"                # all workers reported Trained
    COMPLETED = "completed"            # results served (terminal in reference)
    FAILED = "failed"                  # restart budget exhausted (new: explicit)


class ReplyState(enum.Enum):
    """Reply vocabulary of the reference protocol (TrainerRouterActor.scala:22-33)."""

    NO_TRAINING_DATA = "NoTrainingDataReceived"
    NOT_COMPUTED = "NotComputed"
    TRAINING_NOT_COMPLETED = "TrainingNotCompleted"
    COMPLETED = "Completed"
    RESULT = "Result"


@dataclass(frozen=True)
class QueryReply:
    state: ReplyState
    value: float | None = None

    @property
    def ok(self) -> bool:
        return self.state is ReplyState.RESULT

    def __repr__(self) -> str:  # Result(123.4) / NotComputed
        if self.state is ReplyState.RESULT:
            return f"Result({self.value})"
        return self.state.value


_TRANSITIONS: dict[Phase, set[Phase]] = {
    Phase.AWAITING_DATA: {Phase.READY, Phase.FAILED},
    Phase.READY: {Phase.TRAINING, Phase.AWAITING_DATA, Phase.FAILED},
    Phase.TRAINING: {Phase.TRAINED, Phase.READY, Phase.FAILED},
    Phase.TRAINED: {Phase.COMPLETED, Phase.READY, Phase.FAILED},
    # COMPLETED may re-arm via Initialise (TrainerChildActor.scala:57-59).
    Phase.COMPLETED: {Phase.READY, Phase.FAILED},
    Phase.FAILED: {Phase.READY},
}


class Lifecycle:
    """Thread-safe phase holder with legal-transition enforcement.

    ``on_transition`` (settable post-construction) observes every phase
    change as ``on_transition(old, new)`` — invoked OUTSIDE the lock so an
    observer that queries the lifecycle (the obs flight recorder / trace
    markers) can never deadlock it.
    """

    def __init__(self) -> None:
        self._phase = Phase.AWAITING_DATA
        self._lock = threading.Lock()
        self.start_requested = False  # the "stashed StartTraining" flag
        self.on_transition = None     # callable (old, new) | None

    @property
    def phase(self) -> Phase:
        with self._lock:
            return self._phase

    def to(self, new: Phase) -> None:
        with self._lock:
            if new is self._phase:
                return
            if new not in _TRANSITIONS[self._phase]:
                raise RuntimeError(
                    f"illegal lifecycle transition {self._phase.value} "
                    f"-> {new.value}")
            old, self._phase = self._phase, new
        self._notify(old, new)

    def force(self, new: Phase) -> None:
        with self._lock:
            if new is self._phase:
                return
            old, self._phase = self._phase, new
        self._notify(old, new)

    def _notify(self, old: Phase, new: Phase) -> None:
        if self.on_transition is not None:
            try:
                self.on_transition(old, new)
            except Exception:
                pass    # observability must never break the FSM
