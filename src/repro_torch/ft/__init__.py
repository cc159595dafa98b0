"""Fault tolerance: checkpoint/restart, heartbeat failure detection and
straggler mitigation (the last two numpy/stdlib copies of the
reference's, clocks injected)."""
from . import checkpoint, heartbeat, straggler  # noqa: F401
from .checkpoint import (latest_step, restore_checkpoint,  # noqa: F401
                         save_checkpoint)
from .heartbeat import HeartbeatMonitor  # noqa: F401
from .straggler import StragglerMitigator  # noqa: F401
