"""Training: AdamW, gradient compression, checkpoints and the fault-tolerant
trainer (counterpart of the reference's ``training/``)."""
