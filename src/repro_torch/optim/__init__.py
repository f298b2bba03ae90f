from repro_torch.optim.adamw import AdamWState, Optimizer, adamw, global_norm
from repro_torch.optim.schedule import constant, cosine_with_warmup
