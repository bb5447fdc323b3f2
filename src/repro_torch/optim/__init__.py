"""AdamW on {name: tensor} dicts (counterpart of ``repro.optim``)."""
