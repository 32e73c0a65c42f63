"""The training runtime: the lifecycle protocol and the chunk-loop
orchestrator."""

from sharetrade_tpu_torch.runtime.lifecycle import (  # noqa: F401
    Lifecycle, Phase, QueryReply, ReplyState)
