"""AdamW and the gradient codec on {name: tensor} dicts (counterpart of
``repro.optim``)."""
from repro_torch.optim import adamw, compression
