from repro_torch.roofline.dispatch import analyze_step, StepCost  # noqa: F401
from repro_torch.roofline.analysis import roofline_terms, H100, V5E  # noqa: F401
