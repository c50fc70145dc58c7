"""Models: the dense transformer family, as nn.Modules over plain tensor functions."""

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import LM, padded_vocab, shift_labels

__all__ = ["ArchConfig", "LM", "padded_vocab", "shift_labels"]
