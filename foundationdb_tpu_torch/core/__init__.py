"""Deterministic runtime core: futures, the event loop and the simulator
(copies of foundationdb_tpu.core, kept framework-free)."""

from foundationdb_tpu_torch.core.eventloop import EventLoop, TaskPriority  # noqa: F401
from foundationdb_tpu_torch.core.future import Future, Promise  # noqa: F401
from foundationdb_tpu_torch.core.sim import KillType, SimNetwork  # noqa: F401
