"""Process supervision shared by the port's pools of child processes: the
ladder (:mod:`ladder`). The rollout actors and their pool are not ported;
the fleet's engine pool (``fleet/pool.py``) is the ladder's one user."""
