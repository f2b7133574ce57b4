from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: F401
from repro_torch.serving.scheduler import (FifoScheduler, Scheduler, SloClass,  # noqa: F401
                                           SloScheduler)
from repro_torch.serving.executor import Executor  # noqa: F401
from repro_torch.serving.pool import SlotPool  # noqa: F401
from repro_torch.serving.checkpoint import (EngineCheckpointer, restore_engine,  # noqa: F401
                                            save_engine)
from repro_torch.serving.frontend import ServingFrontend, TokenStream  # noqa: F401
from repro_torch.serving.workload import (Arrival, bursty_arrivals,  # noqa: F401
                                          make_workload, poisson_arrivals,
                                          synthetic_prompts, trace_arrivals)
