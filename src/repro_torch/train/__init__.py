from repro_torch.train.loop import train
from repro_torch.train.step import make_eval_step, make_train_step
