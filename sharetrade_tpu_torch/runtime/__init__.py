"""The training runtime: the lifecycle protocol and the supervised chunk-loop
orchestrator, with the supervision verbs its ``error_policy`` maps
exception types to."""

from sharetrade_tpu_torch.runtime.lifecycle import (  # noqa: F401
    Lifecycle, Phase, QueryReply, ReplyState)
from sharetrade_tpu_torch.runtime.orchestrator import (  # noqa: F401
    DEFAULT_ERROR_POLICY, ESCALATE, RESTART, RESUME, STOP, Orchestrator)
