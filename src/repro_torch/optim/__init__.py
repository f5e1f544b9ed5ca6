from repro_torch.optim.adamw import AdamW, OptState  # noqa: F401
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: F401
