from repro_torch.parallel.api import activate_plan, constrain, current_plan  # noqa: F401
