from .bench import operands, transform_bytes
from .kernel import (LIB, PAIRS, input_transform_cuda, output_transform_cuda,
                     plan)
from .ops import (COUNTER, input_transform, output_transform,
                  winograd_conv)
from .ref import (input_transform_ref, output_transform_ref, tiles,
                  winograd_tensors)

__all__ = ["COUNTER", "LIB", "PAIRS", "input_transform",
           "input_transform_cuda", "input_transform_ref", "output_transform",
           "operands", "output_transform_cuda", "output_transform_ref", "plan",
           "tiles", "transform_bytes", "winograd_conv", "winograd_tensors"]
