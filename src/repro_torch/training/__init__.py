"""Training for the port: AdamW with fp32, bf16 or int8 moments."""
from .optim import (AdamW, QTensor, dequantize, quantize, tree_leaves,
                    tree_map)

__all__ = ["AdamW", "QTensor", "dequantize", "quantize", "tree_leaves",
           "tree_map"]
