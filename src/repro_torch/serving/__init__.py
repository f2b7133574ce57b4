from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: F401
from repro_torch.serving.scheduler import FifoScheduler, Scheduler  # noqa: F401
from repro_torch.serving.executor import Executor  # noqa: F401
from repro_torch.serving.pool import SlotPool  # noqa: F401
