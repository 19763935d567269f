"""Training for the port: AdamW with fp32, bf16 or int8 moments and the
microbatched language-model ``Trainer``."""
from .optim import (AdamW, QTensor, dequantize, quantize, tree_leaves,
                    tree_map)
from .train_step import Trainer

__all__ = ["AdamW", "QTensor", "Trainer", "dequantize", "quantize",
           "tree_leaves", "tree_map"]
