"""Training step (port of ``repro.train``)."""
from repro_torch.train.step import TrainConfig, loss_fn, make_train_step

__all__ = ["TrainConfig", "loss_fn", "make_train_step"]
