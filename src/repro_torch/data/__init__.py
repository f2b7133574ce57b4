"""The synthetic LM data pipeline (counterpart of the reference's ``data/``)."""
