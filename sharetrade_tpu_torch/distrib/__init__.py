"""Disaggregated actor/learner topology, and the supervision ladder every
pool of child processes shares.

Counterpart of the JAX package's ``distrib/``: the reference's ten-worker
actor system (TrainerRouterActor.scala:36) run as separate OS-process
failure domains.

- :mod:`sharetrade_tpu_torch.distrib.actor`: the rollout-actor process body
  (``cli actor``): verified-restore weights from ``tag_best``,
  epsilon-greedy rollouts through a chunk program, a per-actor transitions
  journal, a heartbeat.
- :mod:`sharetrade_tpu_torch.distrib.pool`: the :class:`ActorPool`
  supervisor: spawns, reaps and respawns actor subprocesses under the
  ladder (:mod:`ladder`, shared with the fleet's engine pool), with elastic
  membership (``scale``) against a live learner.

The learner side lives in ``runtime/orchestrator.py``
(``ingest_actor_feeds``): the training loop tails every actor's journal
between dispatches and splices the new rows into its device replay buffer,
so actors die and rejoin without the learner restarting.
"""

from sharetrade_tpu_torch.distrib.actor import RolloutActor, write_heartbeat  # noqa: F401
from sharetrade_tpu_torch.distrib.pool import ActorPool, read_status  # noqa: F401
